"""Spatial face order: the port's ``face_spatial_order`` / ``spatial_sort``
and ``Mesh(spatial_order=True)`` against the JAX package's.

The permutation is host numpy in both packages and must be equal exactly;
a ``Mesh(spatial_order=True)`` of the teapot renders (silhouettes and
textured rgb, 64^2 without anti-aliasing, the JAX renderer run eagerly as
in test_torch_renderer.py) within atol 1e-5 of the JAX package's, with
equal coverage, and its images equal the unordered mesh's (the teapot has
no exact z-ties, so the order changes nothing).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr

torch.set_num_threads(2)

TEAPOT = os.path.join(os.path.dirname(__file__), 'data', 'teapot.obj')
ATOL = 1e-5


@pytest.fixture(scope='module')
def teapot():
    v, f = nr.load_obj(TEAPOT)
    tx = np.random.RandomState(0).uniform(
        -1, 1, (f.shape[0], 2, 2, 2, 3)).astype(np.float32)
    return v, f, tx


def test_face_spatial_order_equals_jax(teapot):
    v, f, _ = teapot
    perm = nt.face_spatial_order(torch.tensor(v), torch.tensor(f))
    np.testing.assert_array_equal(perm, nr.face_spatial_order(v, f))
    assert perm.dtype == np.int32
    assert np.array_equal(np.sort(perm), np.arange(f.shape[0]))


def test_spatial_sort_equals_jax(teapot):
    v, f, tx = teapot
    got = nt.spatial_sort(v, f, tx)
    want = nr.spatial_sort(v, f, tx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert nt.spatial_sort(v, f)[1] is None


def test_mesh_spatial_order_construction(teapot):
    v, f, tx = teapot
    m0 = nt.Mesh(v, tx, f, device='cpu')
    m1 = nt.Mesh(v, tx, f, spatial_order=True, device='cpu')
    want = nr.Mesh(vertices=jnp.asarray(v), textures=jnp.asarray(tx),
                   faces=f, spatial_order=True)
    assert m0.face_order is None
    np.testing.assert_array_equal(m1.face_order, want.face_order)
    np.testing.assert_array_equal(m1.faces.numpy(), np.asarray(want.faces))
    np.testing.assert_array_equal(m1.textures.detach().numpy(),
                                  np.asarray(want.textures))
    np.testing.assert_array_equal(m1.faces.numpy(), f[m1.face_order])
    m2 = nt.Mesh.from_obj(TEAPOT, texture_size=2, device='cpu',
                          spatial_order=True)
    np.testing.assert_array_equal(m2.face_order, m1.face_order)


@pytest.mark.parametrize('ordered', [False, True])
def test_mesh_from_jax_keeps_face_order(teapot, ordered):
    """A JAX mesh built with spatial_order=True converts with its
    permutation and its already reordered faces and textures."""
    v, f, tx = teapot
    mj = nr.Mesh(vertices=jnp.asarray(v), textures=jnp.asarray(tx), faces=f,
                 spatial_order=ordered)
    mt = nt.mesh_from_jax(mj, device='cpu')
    if not ordered:
        assert mt.face_order is None
        return
    assert mt.face_order.dtype == np.int32
    np.testing.assert_array_equal(mt.face_order, mj.face_order)
    np.testing.assert_array_equal(mt.faces.numpy(), f[mt.face_order])
    np.testing.assert_array_equal(mt.textures.detach().numpy(),
                                  tx[mt.face_order])


@pytest.mark.parametrize('mode', ['silhouettes', 'rgb'])
def test_mesh_spatial_order_render_equals_jax(teapot, mode):
    """The JAX renderer gets the port mesh's batch as numpy arrays (its own
    sigmoid rounds differently from torch's)."""
    v, f, tx = teapot
    m = nt.Mesh(v, tx, f, spatial_order=True, device='cpu')
    m_plain = nt.Mesh(v, tx, f, device='cpu')
    r, rj = nt.Renderer(), nr.Renderer()
    for x in (r, rj):
        x.image_size = 64
        x.anti_aliasing = False
    with torch.no_grad():
        batch = m.get_batch(1)
        arrays = [x.numpy() for x in batch]
        if mode == 'silhouettes':
            got = r.render_silhouettes(*batch[:2])
            plain = r.render_silhouettes(*m_plain.get_batch(1)[:2])
            want = rj.render_silhouettes(*arrays[:2])
        else:
            got = r.render(*batch)
            plain = r.render(*m_plain.get_batch(1))
            want = rj.render(*arrays)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if mode == 'silhouettes':
        np.testing.assert_array_equal(got.numpy(), want)
        assert float(got.max()) == 1.0
