"""The port's index-and-depth forward, scene counters, ``measure_scene`` and
``tune`` against the JAX package, on the CPU.

``forward_cuda.forward_face_index_map`` on CPU tensors runs its plain
version, the dense oracle.  It is held against the JAX package's XLA oracle
run op by op (``jax.disable_jit``, ROADMAP Queue 3's jit note) and against
the Pallas kernel ``_tile_kernel`` in interpret mode with a covering
``faces_per_tile_cap``, as tests/test_jax_semantics.py runs it.  Scenes:
random 64^2 (bs 2, nf 40), the same with coincident duplicated faces and
with degenerate faces, and the teapot at 64^2 and 128^2.  Tolerances: face
index maps equal to both; depth bit-equal to the oracle, and within rtol
1e-5 of the interpreted Pallas kernel, whose body XLA compiles as one
program (its fused arithmetic moves sliver faces' depth by up to ~16 ulp;
ROADMAP Queue 3).

The counters (``binning_overflow``, ``chunks_needed``, ``csr_rows_needed``,
``count_out_crossings`` with and without ``per_row``, ``max_out_offset``),
``measure_scene`` and ``tune`` must give the JAX package's integers exactly
on the same inputs, including a 20,000-face scene (above the JAX package's
16,384-face slice) at 32^2.  ``tune`` runs both packages op by op.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import backward as tbwd
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize.config import RasterizeSettings as TSet
from neural_renderer_tpu.rasterize import backward as jbwd
from neural_renderer_tpu.rasterize import forward_pallas, forward_xla
from neural_renderer_tpu.rasterize.config import RasterizeSettings as JSet

torch.set_num_threads(2)

TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')
DUP = 20          # the duplicated scene: face DUP + j is a copy of face j
DEGENERATE = [3, 11, 17, 25, 31]


def _random(seed=7):
    rng = np.random.RandomState(seed)
    fc = rng.uniform(-0.9, 0.9, (2, 40, 3, 3)).astype(np.float32)
    fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
    return fc


def _teapot():
    """Teapot NDC faces (fill_back) at azimuths 30 and 200."""
    v, f = nt.load_obj(TEAPOT)
    r = nt.Renderer()
    faces = r._fill_back_faces(torch.as_tensor(f[None].astype(np.int64)))
    out = []
    for az in (30.0, 200.0):
        r.eye = nt.get_points_from_angles(2.732, 30.0, az)
        out.append(nt.vertices_to_faces(r._transform(torch.as_tensor(
            v[None])), faces))
    return torch.cat(out).numpy()


def _large(nf=20000, seed=3):
    """Small random triangles, half of them back-facing."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-0.95, 0.95, (1, nf, 1, 3)).astype(np.float32)
    fc = c + rng.uniform(-0.08, 0.08, (1, nf, 3, 3)).astype(np.float32)
    fc[..., 2] = rng.uniform(0.5, 2.0, (1, nf, 3))
    return fc


def _scene(name):
    if name == 'random':
        return _random()
    if name == 'duplicated':
        fc = _random()
        fc[:, DUP:] = fc[:, :DUP]
        return fc
    if name == 'degenerate':
        fc = _random()
        fc[:, DEGENERATE[:3]] = 0.0                        # all-zero faces
        fc[:, DEGENERATE[3:], 1] = fc[:, DEGENERATE[3:], 0]  # zero area
        return fc
    if name == 'teapot':
        return _teapot()
    return _large()


@pytest.fixture(scope='module')
def scenes():
    return {name: _scene(name) for name in
            ('random', 'duplicated', 'degenerate', 'teapot', 'large')}


def _port_fim(fc, size):
    return forward_cuda.forward_face_index_map(TSet(image_size=size),
                                               torch.as_tensor(fc))


@pytest.mark.parametrize('name,size', [
    ('random', 64), ('duplicated', 64), ('degenerate', 64), ('teapot', 64),
    ('teapot', 128)])
def test_index_map_matches_jax(scenes, name, size):
    fc = scenes[name]
    before = tracing.counts()
    idx, depth = (t.numpy() for t in _port_fim(fc, size))
    assert tracing.counts() == before
    js = JSet(image_size=size, runtime_checks=False,
              faces_per_tile_cap=fc.shape[1])
    with jax.disable_jit():
        xi, xd = (np.asarray(a) for a in forward_xla.forward_face_index_map(
            js, jnp.asarray(fc)))
    pi, pd = (np.asarray(a) for a in forward_pallas.forward_face_index_map(
        js, jnp.asarray(fc), interpret=True))
    np.testing.assert_array_equal(idx, xi)
    np.testing.assert_array_equal(idx, pi)
    np.testing.assert_array_equal(depth, xd)
    np.testing.assert_allclose(depth, pd, rtol=1e-5, atol=0)
    assert depth.dtype == np.float32 and idx.dtype == np.int32
    covered = idx >= 0
    assert covered.sum() > 400
    np.testing.assert_array_equal(depth[~covered], 100.0)
    assert (depth[covered] < 100.0).all()
    if name == 'duplicated':
        # every face has a coincident copy of higher id: ties go to the
        # lower id (the reference's first-wins rule)
        assert idx.max() < DUP
    if name == 'degenerate':
        assert not np.isin(idx, DEGENERATE).any()


def _both_fims(fc, size):
    """The face-index map (the port's plain version, which the test above
    holds equal to the JAX oracle) as a torch and a JAX array."""
    fim = _port_fim(fc, size)[0]
    return fim, jnp.asarray(fim.numpy())


@pytest.mark.parametrize('name,size', [
    ('random', 64), ('degenerate', 64), ('teapot', 64), ('teapot', 100),
    ('teapot', 128), ('large', 32)])
def test_scene_counters_match_jax(scenes, name, size):
    fc = scenes[name]
    ft, fj = torch.as_tensor(fc), jnp.asarray(fc)
    ts = TSet(image_size=size)
    js = JSet(image_size=size, runtime_checks=False)
    assert forward_cuda.slice_size() == forward_pallas.slice_size() == 16384
    got = forward_cuda.binning_overflow(ts, ft)
    assert got == int(forward_pallas.binning_overflow(js, fj)) > 0
    for cap in (None, 128):
        jc = JSet(image_size=size, runtime_checks=False,
                  faces_per_tile_cap=cap)
        assert forward_cuda.chunk_capacity(ts, fc.shape[1], cap) == \
            forward_pallas.chunk_capacity(jc, fc.shape[1])
        assert forward_cuda.chunks_needed(ts, ft, cap) == \
            int(forward_pallas.chunks_needed(jc, fj))
        if fc.shape[1] <= 16384:
            assert forward_cuda.csr_rows_needed(ts, ft, cap) == \
                int(forward_pallas.csr_rows_needed(jc, fj))
        else:
            with pytest.raises(ValueError, match='single-pass'):
                forward_cuda.csr_rows_needed(ts, ft, cap)
    fim_t, fim_j = _both_fims(fc, size)
    for per_row in (False, True):
        got = tbwd.count_out_crossings(ts, ft, fim_t, per_row=per_row)
        assert got == int(jbwd.count_out_crossings(js, fj, fim_j,
                                                   per_row=per_row)) > 0
    got = tbwd.max_out_offset(ts, ft, fim_t)
    assert got == float(jbwd.max_out_offset(js, fj, fim_j)) > 0


def test_patch_counts_split_at_the_slice_size(scenes):
    """Above 16,384 faces the JAX package bins each slice on its own: the
    overflow is the larger slice's maximum, not the whole mesh's."""
    fc = torch.as_tensor(scenes['large'])
    s = TSet(image_size=32)
    whole = int(forward_cuda.patch_counts(s, fc).max())
    first = int(forward_cuda.patch_counts(s, fc[:, :16384]).max())
    rest = int(forward_cuda.patch_counts(s, fc[:, 16384:]).max())
    assert forward_cuda.binning_overflow(s, fc) == max(first, rest) < whole


@pytest.mark.parametrize('name,size', [
    ('random', 64), ('teapot', 64), ('teapot', 128), ('large', 32)])
def test_measure_scene_matches_jax(scenes, name, size):
    fc = scenes[name]
    js = JSet(image_size=size, runtime_checks=False)
    with jax.disable_jit():
        want = nr.measure_scene(js, jnp.asarray(fc))
    got = nt.measure_scene(TSet(image_size=size), torch.as_tensor(fc))
    assert set(got) == set(want)
    assert got == {k: (float if k == 'out_offset' else int)(np.asarray(v))
                   for k, v in want.items()}


def _tune_scene(name):
    """(vertices, faces, JAX eyes, image size): test_tune.py's scene at 32^2
    over its three eyes, or the teapot at 64^2 over three azimuths."""
    if name == 'tetra':
        v = (np.array([[1., 0., 0.], [0., 1., 0.], [0., 0., 1.],
                       [0., 0., 0.]], np.float32) * 2 - 1)
        f = np.array([[1, 3, 2], [3, 1, 0], [2, 0, 1], [0, 2, 3]], np.int32)
        eyes = [nr.get_points_from_angles(
            np.float32(2.732), np.float32(15.0), np.float32(a))
            for a in (0.0, 90.0, 180.0)]
        return v, f, eyes, 32
    v, f = nr.load_obj(TEAPOT)
    eyes = [nr.get_points_from_angles(
        np.float32(2.732), np.float32(30.0), np.float32(a))
        for a in (20.0, 140.0, 260.0)]
    return v, f, eyes, 64


@pytest.mark.parametrize('name,aa,margin', [
    ('tetra', False, 1.25), ('tetra', True, 1.0), ('tetra', 'approx', 1.25),
    ('teapot', False, 1.0), ('teapot', True, 1.25),
    ('teapot', 'approx', 1.0)])
def test_tune_matches_jax(name, aa, margin):
    v, f, eyes, size = _tune_scene(name)
    rj, rt = nr.Renderer(), nt.Renderer()
    for r in (rj, rt):
        r.image_size = size
        r.anti_aliasing = aa
    with jax.disable_jit():
        want = nr.tune(rj, jnp.asarray(v), jnp.asarray(f), eyes=eyes,
                       margin=margin)
    saved_eye = rt.eye
    got = nt.tune(rt, torch.as_tensor(v), torch.as_tensor(f),
                  eyes=[np.array(e) for e in eyes], margin=margin)
    assert got == want
    assert rt.eye is saved_eye
    assert rt.perf_overrides == got
    assert {'faces_per_tile_cap', 'grad_out_cap', 'grad_offset_radius',
            'forward_chunk_budget', 'grad_csr_rows'} <= set(got)


def test_tune_measure_declines_and_leaves_the_renderer():
    """``measure=True``: both phases run, a warning gives the reason, and
    the renderer keeps its eye and its empty ``perf_overrides``."""
    v, f, eyes, size = _tune_scene('tetra')
    r = nt.Renderer()
    r.image_size = size
    saved_eye = r.eye
    with pytest.warns(UserWarning, match='same program'):
        got = nt.tune(r, torch.as_tensor(v), torch.as_tensor(f),
                      eyes=[np.array(e) for e in eyes], margin=1.0,
                      textures=np.ones((1, 4, 2, 2, 2, 3), np.float32),
                      measure=True)
    assert got == {}
    assert r.perf_overrides == {}
    assert r.eye is saved_eye
