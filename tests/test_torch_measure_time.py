"""``misc/torch_measure_time.py`` against ``misc/measure_time.py``.

The port's four callables of an eye (``build``) at ``-is 32`` (a 64^2
raster with AA) on the CPU, against the JAX script's lambdas rebuilt here
with the JAX package and run eagerly (ROADMAP Queue 3: the jitted JAX
render rounds sliver faces otherwise), each side making its own eye from
azimuths 0 and 45 as its script does (the eyes are bit-equal).

The two packages' camera rotations differ by up to 4.8e-7 in camera space
at these eyes (ROADMAP Queue 3, "Camera rotation"), which moves a few
vertex-gradient elements out of ``tests/test_torch_train.py``'s band (up to
0.19% of max |grad| at azimuth 45) and texture gradients by up to 0.13% of
their max.  So the images are compared as the script makes them, within
atol 1e-6 (0 and 1.2e-7 measured; the pin allows 1.66e-4), and all four
callables again with the port's camera-space vertices given the JAX
package's values (their gradient still the port's): images within atol
1e-6, vertex gradients within the band (rtol 1e-4, atol 1e-5 x max
|grad|), texture gradients within 1e-5 x max |value|.  Also ``run`` at
``-is 16 -bs 2``: four finite positive means, printed in the JAX script's
format.
"""

import contextlib
import importlib.util
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEAPOT = os.path.join(ROOT, 'tests', 'data', 'teapot.obj')
IS = 32
AZIMUTHS = (0, 45)
# images, as the script makes them and on the same camera values
IMAGE_ATOL = 1e-6


@pytest.fixture(scope='module')
def script():
    path = os.path.join(ROOT, 'misc', 'torch_measure_time.py')
    spec = importlib.util.spec_from_file_location('test_torch_measure_time_',
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def jax_calls():
    """misc/measure_time.py's four functions of (v, [tx,] eye), unjitted,
    with its inputs at batch 1 and ``IS``."""
    v, f = nr.load_obj(TEAPOT)
    vertices = jnp.asarray(v[None])
    faces = jnp.asarray(f[None])
    textures = jnp.ones((1, f.shape[0], 2, 2, 2, 3), jnp.float32)
    renderer = nr.Renderer()
    renderer.image_size = IS

    def render_sil(v, eye):
        renderer.eye = eye
        return renderer.render_silhouettes(v, faces)

    def render_rgb(v, tx, eye):
        renderer.eye = eye
        return renderer.render(v, faces, tx)

    bwd_sil = jax.grad(lambda v, eye: jnp.sum(render_sil(v, eye)))
    bwd_rgb = jax.grad(lambda v, tx, eye: jnp.sum(render_rgb(v, tx, eye)),
                       argnums=(0, 1))
    return (lambda eye: render_sil(vertices, eye),
            lambda eye: (bwd_sil(vertices, eye),),
            lambda eye: render_rgb(vertices, textures, eye),
            lambda eye: bwd_rgb(vertices, textures, eye))


def _same_camera(monkeypatch):
    """The port's camera-space vertices take the JAX package's values for
    the same eye (the port's transform still carries the gradient)."""
    transform = nt.Renderer._transform

    def snapped(self, vertices):
        got = transform(self, vertices)
        r = nr.Renderer()
        r.eye = jnp.asarray(self.eye.detach().numpy())
        want = np.asarray(r._transform(jnp.asarray(
            vertices.detach().numpy())))
        return got + (torch.from_numpy(want.copy()) - got).detach()

    monkeypatch.setattr(nt.Renderer, '_transform', snapped)


def _callables(script, jax_calls, azimuth, kinds):
    """[(kind, port result, JAX result)] of the callables of ``kinds`` at
    ``azimuth``, each side's eye made by its script."""
    calls = script.build(script.parse_args(['-is', str(IS), '--device',
                                            'cpu']))
    eye = script.eye_at(azimuth, 'cpu')
    eye_j = jnp.asarray(nr.get_points_from_angles(
        np.float32(2.732), np.float32(30), np.float32(azimuth)))
    assert np.array_equal(eye.numpy(), np.asarray(eye_j))
    return [(kind, call(eye), call_j(eye_j))
            for kind, call, call_j in zip(script.KINDS, calls, jax_calls)
            if kind in kinds]


def _assert_images(kind, got, want):
    want = np.asarray(want)
    assert got.shape == want.shape, kind
    assert want.max() > 0.5, kind
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMAGE_ATOL,
                               err_msg=kind)


@pytest.mark.parametrize('azimuth', AZIMUTHS)
def test_images_match_jax(script, jax_calls, azimuth):
    forward = [k for k in script.KINDS if 'forward' in k]
    for kind, got, want in _callables(script, jax_calls, azimuth, forward):
        _assert_images(kind, got, want)


@pytest.mark.parametrize('azimuth', AZIMUTHS)
def test_callables_match_jax_on_the_same_camera(script, jax_calls, azimuth,
                                                 monkeypatch):
    _same_camera(monkeypatch)
    for kind, got, want in _callables(script, jax_calls, azimuth,
                                      script.KINDS):
        if 'forward' in kind:
            _assert_images(kind, got, want)
            continue
        assert len(got) == len(want), kind
        for name, g, w in zip(('vertices', 'textures'), got, want):
            w = np.asarray(w)
            scale = np.abs(w).max()
            assert scale > 0, (kind, name)
            # vertices: tests/test_torch_train.py's band
            rtol = 1e-4 if name == 'vertices' else 0
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                       atol=1e-5 * scale,
                                       err_msg=f'{kind} {name}')


def test_run_prints_the_jax_format(script):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        means = script.run(['-is', '16', '-bs', '2', '--device', 'cpu'])
    assert len(means) == 4
    assert all(np.isfinite(m) and m > 0 for m in means), means
    lines = buf.getvalue().strip().splitlines()
    assert [ln.split(' time:')[0] for ln in lines] == list(script.KINDS)
    for line, ms in zip(lines, means):
        assert re.fullmatch(r'(silhouette|texture) (forward|backward) '
                            r'time: \d+\.\d{3} ms', line), line
        assert line.endswith(f'{ms:.3f} ms'), (line, ms)


def test_no_card_raises(script):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        script.run(['-is', '16'])
