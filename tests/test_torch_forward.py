"""Parity of the port's shaded forward (plain version) with the JAX package.

``forward_cuda.forward_shaded_plain`` — what ``forward_shaded`` runs on a CPU
tensor — is held against the JAX XLA path (``forward_xla`` +
``texture.sample_textures``) and against the Pallas kernel itself in
interpret mode, on a random 64^2 scene (bs 2, nf 40) with no textures and
ts 2, 3, 4.  The JAX functions run eagerly, op by op, as the port does.

Tolerances:
  * face_index_map exactly equal;
  * weights, depth, xy, z: rtol 1e-5, atol 1e-6;
  * rgb: rtol 1e-4, atol 1e-5 — the Pallas kernel shades ts 3/4 with a hat
    product whose terms and sum order differ from the 8-corner form.

The binning that feeds the CUDA kernel is plain PyTorch and runs here: every
pixel's dense winner must lie in its tile's face list.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import (forward_cuda, forward_dense,
                                             geometry)
from neural_renderer_torch.rasterize.config import RasterizeSettings as TSet
from neural_renderer_tpu.rasterize import forward_pallas, forward_xla
from neural_renderer_tpu.rasterize import texture as jtex
from neural_renderer_tpu.rasterize.config import RasterizeSettings as JSet

torch.set_num_threads(2)

IS = 64
TOL = dict(rtol=1e-5, atol=1e-6)
RGB_TOL = dict(rtol=1e-4, atol=1e-5)


def _scene(ts, seed=7):
    """faces [2, 40, 3, 3] NDC with z in [0.73, 1.27] (as
    test_shaded_texture's scene) and optional textures, from a numpy seed."""
    rng = np.random.RandomState(seed)
    fc = rng.uniform(-0.9, 0.9, (2, 40, 3, 3)).astype(np.float32)
    fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
    tx = (None if ts is None else
          rng.uniform(0, 1, (2, 40, ts, ts, ts, 3)).astype(np.float32))
    return fc, tx


def _plain(fc, tx):
    s = TSet(image_size=IS, eps=1e-3)
    out = forward_cuda.forward_shaded_plain(
        s, torch.as_tensor(fc), None if tx is None else torch.as_tensor(tx))
    return {k: v.numpy() for k, v in out.items()}


def _jax_settings(**kw):
    return JSet(image_size=IS, eps=1e-3, runtime_checks=False, **kw)


def _assert_maps(got, want):
    np.testing.assert_array_equal(got['face_index_map'],
                                  want['face_index_map'])
    assert (want['face_index_map'] >= 0).sum() > 500
    for key in ('depth_map', 'weights', 'xy', 'z'):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    if 'rgb' in want:
        np.testing.assert_allclose(got['rgb'], want['rgb'], err_msg='rgb',
                                   **RGB_TOL)


@pytest.mark.parametrize('ts', [None, 2, 3, 4])
def test_plain_matches_jax_xla(ts):
    fc, tx = _scene(ts)
    s = _jax_settings(backend='xla')
    f = jnp.asarray(fc)
    fim, _ = forward_xla.forward_face_index_map(s, f)
    face_w = forward_xla.gather_face_rows(f, fim)
    wm, dm, _ = forward_xla.winner_attributes(s, f, fim, face_w,
                                              need_face_inv=False)
    covered = np.asarray(fim >= 0)[..., None, None]
    fw = np.where(covered, np.asarray(face_w), 0.0)
    want = dict(face_index_map=np.asarray(fim), depth_map=np.asarray(dm),
                weights=np.asarray(wm).transpose(0, 3, 1, 2),
                xy=fw[..., 0:2].reshape(2, IS, IS, 6).transpose(0, 3, 1, 2),
                z=fw[..., 2].transpose(0, 3, 1, 2))
    if tx is not None:
        rgb = jtex.sample_textures(s, f, jnp.asarray(tx), fim, face_w, wm, dm)
        want['rgb'] = np.asarray(rgb).transpose(0, 3, 1, 2)
    _assert_maps(_plain(fc, tx), want)


@pytest.mark.parametrize('ts', [None, 2, 3, 4])
def test_plain_matches_pallas_interpret(ts):
    fc, tx = _scene(ts)
    s = _jax_settings(backend='pallas', return_depth=False)
    out = forward_pallas.forward_shaded(
        s, jnp.asarray(fc), None if tx is None else jnp.asarray(tx),
        interpret=True)
    want = {k: np.asarray(v) for k, v in out.items() if k != 'zraw'}
    _assert_maps(_plain(fc, tx), want)


def _teapot_faces(image_size):
    """NDC faces of the teapot test batch (rows 0, 1, 3 all-zero meshes)."""
    vertices, faces, textures = utils.load_teapot_batch()
    r = nt.Renderer()
    r.eye = [1.0, 1.0, -2.7]
    r.image_size = image_size
    fc, _ = r._lit_faces(*nt.arrays_from_numpy(vertices, faces, textures,
                                                device='cpu'))
    return fc


@pytest.mark.parametrize('scene,image_size,tile', [
    ('random', 64, 16), ('random', 64, 8), ('random', 100, 16),
    ('teapot', 64, 16), ('teapot', 100, 32)])
def test_binning_holds_every_winner(scene, image_size, tile):
    faces = (torch.as_tensor(_scene(None)[0]) if scene == 'random'
             else _teapot_faces(image_size))
    s = TSet(image_size=image_size, eps=1e-3)
    fim, _ = forward_dense.forward_face_index_map(s, faces)
    start, ids, _, _ = forward_cuda.bin_faces(s, faces, tile)
    nt_ = -(-image_size // tile)
    bs = faces.shape[0]
    assert start.shape == (bs * nt_ * nt_ + 1,)
    assert int(start[-1]) == ids.shape[0]
    front = geometry.is_frontface(faces)
    n_checked = 0
    for b in range(bs):
        for ty in range(nt_):
            for tx in range(nt_):
                t = (b * nt_ + ty) * nt_ + tx
                lst = ids[start[t]:start[t + 1]].long()
                # ascending, front faces only
                assert bool((lst[1:] > lst[:-1]).all())
                assert bool(front[b, lst].all())
                win = fim[b, ty * tile:(ty + 1) * tile,
                          tx * tile:(tx + 1) * tile]
                win = win[win >= 0].long().unique()
                assert bool(torch.isin(win, lst).all()), (b, ty, tx)
                n_checked += win.numel()
    assert n_checked > 50


def test_kernel_wrapper_routes_cpu_to_plain():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    fc, tx = _scene(2)
    s = TSet(image_size=IS, eps=1e-3)
    before = tracing.counts()
    got = forward_cuda.forward_shaded(s, torch.as_tensor(fc),
                                      torch.as_tensor(tx))
    assert tracing.counts() == before
    _assert_maps({k: v.numpy() for k, v in got.items()}, _plain(fc, tx))
