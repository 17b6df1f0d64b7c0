"""Parity of the port's ops (neural_renderer_torch.ops) with the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU.
Tolerance rtol 1e-6, atol 1e-6: the same f32 elementwise math, where only
the order of a 3-term sum (and libm's last bit in tan/sin/cos) may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr

torch.set_num_threads(2)

RTOL = ATOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _rng():
    return np.random.RandomState(1234)


def test_cross():
    rng = _rng()
    a = rng.randn(64, 3).astype(np.float32)
    b = rng.randn(64, 3).astype(np.float32)
    _close(nt.cross(torch.as_tensor(a), torch.as_tensor(b)), nr.cross(a, b))


@pytest.mark.parametrize('eye_kind', ['list', 'batched'])
def test_look_at(eye_kind):
    rng = _rng()
    v = rng.uniform(-1, 1, (3, 50, 3)).astype(np.float32)
    eye = ([0.3, 1.2, -2.5] if eye_kind == 'list'
           else rng.uniform(-3, 3, (3, 3)).astype(np.float32))
    _close(nt.look_at(torch.as_tensor(v), eye), nr.look_at(v, eye))


def test_look():
    rng = _rng()
    v = rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
    eye = [0.5, -0.4, -2.0]
    direction = [0.1, -0.2, 1.0]
    _close(nt.look(torch.as_tensor(v), eye, direction),
           nr.look(v, eye, direction))


@pytest.mark.parametrize('angle', [30.0, 47.5])
def test_perspective(angle):
    rng = _rng()
    v = rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
    v[..., 2] += 3.0
    _close(nt.perspective(torch.as_tensor(v), angle),
           nr.perspective(v, angle))


def test_get_points_from_angles():
    # scalar branch: the same Python math
    assert (nt.get_points_from_angles(2.732, 30, 45)
            == nr.get_points_from_angles(2.732, 30, 45))
    # array branch
    rng = _rng()
    d = rng.uniform(1, 3, 8).astype(np.float32)
    el = rng.uniform(-60, 60, 8).astype(np.float32)
    az = np.linspace(0, 315, 8).astype(np.float32)
    _close(nt.get_points_from_angles(*map(torch.as_tensor, (d, el, az))),
           nr.get_points_from_angles(d, el, az))


@pytest.mark.parametrize('light', ['default', 'custom'])
def test_lighting(light):
    rng = _rng()
    faces = rng.uniform(-1, 1, (2, 30, 3, 3)).astype(np.float32)
    tex = rng.uniform(0, 1, (2, 30, 2, 2, 2, 3)).astype(np.float32)
    args = (() if light == 'default'
            else (0.3, 0.8, [1.0, 0.5, 0.25], [0.2, 0.9, 0.4], [0.3, 0.6, -1]))
    _close(nt.lighting(torch.as_tensor(faces), torch.as_tensor(tex), *args),
           nr.lighting(jnp.asarray(faces), jnp.asarray(tex), *args))


def test_vertices_to_faces():
    rng = _rng()
    v = rng.randn(3, 17, 3).astype(np.float32)
    f = rng.randint(0, 17, (3, 25, 3)).astype(np.int32)
    got = nt.vertices_to_faces(torch.as_tensor(v), torch.as_tensor(f))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(nr.vertices_to_faces(v, f)))
