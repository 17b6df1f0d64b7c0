"""The port's backward pieces (plain versions) against the JAX package.

On CPU tensors ``backward_cuda``'s wrappers run their plain PyTorch
versions; these are held against the JAX package's CPU path, which runs
eagerly here, op by op (ROADMAP Queue 3), on the teapot at 64^2 (bs 2, two
azimuths) with random value and gradient maps from a numpy seed:

  * the K5 stacks (in-sweep + out-sweep, both axes; rgb, alpha, rgb+alpha)
    against ``backward.pixel_map_channels`` (dense, exact gather): rtol
    1e-4 and atol 1e-5 x the channel's max |value| (the out-sweep sums run
    in another order);
  * the K6 factors and cell rows against ``texture.py`` at covered pixels,
    and the K7 channels against ``depth_channels``: rtol 1e-6, atol 1e-7 x
    max (the same operations in the same order);
  * ``face_reduce_plain`` against ``jax.ops.segment_sum``: rtol 1e-5, atol
    1e-6 x max (sum order), and the tile-pair bookkeeping of the card's
    reduction against ``face_reduce_plain`` at the same tolerance;
    ``face_reduce`` building the K6 factors from the maps against the
    route in which the stack carried them, and its card route (a fake
    kernel reading what the wrapper hands over) against the plain
    version: bit for bit;
  * the exact background gradient against ``jax.grad``: rtol 1e-5;
  * the four hard-coded gradient cases (rtol 1e-2, atol 1e-5, the
    reference's own) and the float64 K5 pipeline of test_grad_parity64
    (rtol 1e-3, atol 1e-4 x max), through ``torch.autograd``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
import torch_fakes
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import backward as tbwd
from neural_renderer_torch.rasterize import backward_cuda, forward_cuda
from neural_renderer_torch.rasterize import geometry as tgeo
from neural_renderer_torch.rasterize import texture as ttex
from neural_renderer_torch.rasterize.config import RasterizeSettings as TSet
from neural_renderer_tpu.rasterize import backward as jbwd
from neural_renderer_tpu.rasterize import forward_xla, geometry
from neural_renderer_tpu.rasterize import texture as jtex
from neural_renderer_tpu.rasterize.config import RasterizeSettings as JSet
from test_grad_parity64 import CASES, HARDCODED, _reference_grad64

torch.set_num_threads(2)

IS = 64
EPS = 1e-3


def _close(got, want, rtol, frac, axis=None):
    """|got - want| <= rtol |want| + frac max|want|, the max taken per
    channel along ``axis`` when given."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if axis is None:
        scale = np.abs(want).max()
    else:
        other = tuple(i for i in range(want.ndim) if i != axis)
        scale = np.abs(want).max(axis=other, keepdims=True)
    err = np.abs(got - want)
    bad = ~(err <= rtol * np.abs(want) + frac * scale)
    assert not bad.any(), (f'{bad.sum()} of {bad.size} differ; max abs err '
                           f'{err.max()}, scale {np.max(scale)}')


@pytest.fixture(scope='module')
def scene():
    """Teapot NDC faces at two azimuths, the JAX forward maps over them and
    random rgb / gradient maps, all from numpy seed 0."""
    v, f = nt.load_obj(str(utils.DATA_DIR) + '/teapot.obj')
    r = nt.Renderer()
    r.image_size = IS
    fcs = []
    for az in (30.0, 200.0):
        r.eye = nt.get_points_from_angles(2.732, 30.0, az)
        fc, _ = r._lit_faces(*nt.arrays_from_numpy(
            v[None], f[None], np.ones((1, f.shape[0], 2, 2, 2, 3),
                                      np.float32), device='cpu'))
        fcs.append(fc)
    fc = torch.cat(fcs).numpy()
    s = JSet(image_size=IS, eps=EPS, runtime_checks=False)
    fj = jnp.asarray(fc)
    fim, _ = forward_xla.forward_face_index_map(s, fj)
    face_w = forward_xla.gather_face_rows(fj, fim)
    wm, dm, _ = forward_xla.winner_attributes(s, fj, fim, face_w,
                                              need_face_inv=False)
    fim = np.array(fim)
    covered = fim >= 0
    fw = np.where(covered[..., None, None], np.array(face_w), 0.0)
    rng = np.random.RandomState(0)
    shape = fim.shape
    return dict(
        faces=fc, fim=fim, covered=covered, face_w=np.array(face_w),
        weights=np.array(wm), depth=np.array(dm),
        xy=fw[..., 0:2].reshape(*shape, 6).transpose(0, 3, 1, 2).copy(),
        z=fw[..., 2],
        rgb=rng.uniform(0, 1, shape + (3,)).astype(np.float32),
        grgb=rng.normal(0, 1, shape + (3,)).astype(np.float32),
        galpha=rng.normal(0, 1, shape).astype(np.float32),
        gdepth=rng.normal(0, 1, shape).astype(np.float32))


def _settings(mode):
    flags = dict(return_rgb='rgb' in mode, return_alpha='alpha' in mode,
                 return_depth=False)
    return (TSet(image_size=IS, eps=EPS, **flags),
            JSet(image_size=IS, eps=EPS, runtime_checks=False, **flags))


def _port_k5(ts_, sc, fn):
    t = torch.as_tensor
    return fn(ts_, t(sc['xy']), t(sc['fim']),
              t(sc['rgb']).permute(0, 3, 1, 2), t(sc['grgb']).permute(
                  0, 3, 1, 2), t(sc['galpha'])).numpy()


@pytest.mark.parametrize('mode', ['rgb', 'alpha', 'rgb+alpha'])
def test_k5_stack_matches_jax(scene, mode):
    ts_, js = _settings(mode)
    sc = scene
    want, extra = jbwd.pixel_map_channels(
        js, jnp.asarray(sc['faces']), jnp.asarray(sc['fim']),
        jnp.asarray(sc['face_w']), jnp.asarray(sc['rgb']),
        jnp.asarray(sc['covered'], jnp.float32), jnp.asarray(sc['grgb']),
        jnp.asarray(sc['galpha']))
    assert extra is None
    want = np.asarray(want)
    got_in = _port_k5(ts_, sc, backward_cuda.insweep_plain)
    got_out = _port_k5(ts_, sc, backward_cuda.outsweep_plain)
    assert np.abs(got_in).max() > 0 and np.abs(got_out).max() > 0
    _close(got_in + got_out, want, 1e-4, 1e-5, axis=1)


def test_wrappers_route_cpu_to_plain(scene):
    """On CPU tensors the wrappers run the plain versions, launch nothing,
    and the out-sweep's accumulate adds to the in-sweep in place."""
    ts_, _ = _settings('rgb+alpha')
    sc = scene
    before = tracing.counts()
    want = (_port_k5(ts_, sc, backward_cuda.insweep_plain)
            + _port_k5(ts_, sc, backward_cuda.outsweep_plain))
    stack = torch.zeros((2, 15, IS, IS))
    view = stack[:, 2:14]
    _port_k5(ts_, sc, lambda *a: backward_cuda.insweep(*a, out=view))
    _port_k5(ts_, sc, lambda *a: backward_cuda.outsweep(
        *a, out=view, accumulate=True))
    np.testing.assert_array_equal(view.numpy(), want)
    assert stack[:, [0, 1, 14]].abs().max() == 0
    sums = backward_cuda.face_reduce(stack, torch.as_tensor(sc['fim']), 4928)
    np.testing.assert_array_equal(sums.numpy(), backward_cuda.
                                  face_reduce_plain(stack, torch.as_tensor(
                                      sc['fim']), 4928).numpy())
    assert tracing.counts() == before


@pytest.mark.parametrize('ts', [2, 3, 4])
def test_k6_factors_and_cells_match_jax(scene, ts):
    sc = scene
    s = TSet(image_size=IS, eps=EPS)
    js = JSet(image_size=IS, eps=EPS, runtime_checks=False)
    t = torch.as_tensor
    got = ttex.texture_cell_factors(
        s, t(sc['fim']), t(sc['z']), t(sc['weights']), t(sc['depth']),
        t(sc['grgb']).permute(0, 3, 1, 2), ts)
    args = (jnp.asarray(sc['fim']), jnp.asarray(sc['face_w']),
            jnp.asarray(sc['weights']), jnp.asarray(sc['depth']),
            jnp.asarray(sc['grgb']))
    want = np.asarray(jtex.texture_cell_factors(js, *args, ts))
    assert got.shape == want.shape == (2, ts * ts + ts + 3, IS, IS)
    _close(got.numpy(), want, 1e-6, 1e-7)
    cells = ttex.texture_channels_cells(got, ts).numpy()
    want_cells = np.asarray(
        jtex.texture_channels_ts2(js, *args) if ts == 2
        else jtex.texture_channels_cells(js, *args, ts))
    cov = sc['covered'][:, None]
    _close(np.where(cov, cells, 0), np.where(cov, want_cells, 0), 1e-6, 1e-7)
    assert np.abs(cells).max() > 0


def test_k6_grad_textures_matches_jax(scene):
    """The 8-corner scatter (the backward's path for ts > 4)."""
    sc = scene
    ts, nf = 5, sc['faces'].shape[1]
    shape = (2, nf, ts, ts, ts, 3)
    got = ttex.grad_textures(
        TSet(image_size=IS, eps=EPS), torch.as_tensor(sc['fim']),
        torch.as_tensor(sc['z']), torch.as_tensor(sc['weights']),
        torch.as_tensor(sc['depth']), torch.as_tensor(sc['grgb']), shape)
    want = jtex.grad_textures(
        JSet(image_size=IS, eps=EPS, runtime_checks=False),
        jnp.asarray(sc['faces']), jnp.asarray(sc['fim']),
        jnp.asarray(sc['face_w']), jnp.asarray(sc['weights']),
        jnp.asarray(sc['depth']), jnp.asarray(sc['grgb']), shape)
    _close(got.numpy(), want, 1e-5, 1e-6)


def test_k7_channels_match_jax(scene):
    sc = scene
    s = TSet(image_size=IS, eps=EPS)
    js = JSet(image_size=IS, eps=EPS, runtime_checks=False)
    fw = jnp.asarray(sc['face_w'])
    finv = geometry.face_inv_matrix(geometry.to_pixel_coords(fw[..., 0], IS),
                                    geometry.to_pixel_coords(fw[..., 1], IS))
    finv = jnp.where(jnp.asarray(sc['covered'])[..., None, None], finv, 0.0)
    want = np.asarray(jbwd.depth_channels(
        js, jnp.asarray(sc['faces']), jnp.asarray(sc['fim']), fw, finv,
        jnp.asarray(sc['weights']), jnp.asarray(sc['depth']),
        jnp.asarray(sc['gdepth'])))
    t = torch.as_tensor
    ppx, ppy = tbwd.pixel_coords(t(sc['xy']), IS)
    tfinv = torch.where(t(sc['covered'])[..., None, None],
                        tgeo.face_inv_matrix(ppx, ppy), 0.0)
    got = tbwd.depth_channels(s, t(sc['covered']), t(sc['z']), tfinv,
                              t(sc['weights']), t(sc['depth']),
                              t(sc['gdepth'])).numpy()
    assert np.abs(want).max() > 0
    _close(got, want, 1e-6, 1e-7)


def _k6_maps(sc, ts, grad_rgb=None):
    """The scene's maps as the backward hands them to the reduction: z and
    weights channel-leading views of the NHWC maps, the rgb gradient as
    NHWC (``grad_rgb`` in its place when given)."""
    t = torch.as_tensor
    return backward_cuda.K6Maps(
        TSet(image_size=IS, eps=EPS), ts, t(sc['z']).permute(0, 3, 1, 2),
        t(sc['weights']).permute(0, 3, 1, 2), t(sc['depth']),
        t(sc['grgb']) if grad_rgb is None else grad_rgb)


def _reduce_stack(sc, ts, k5=True):
    """A random 12-channel stack (no channel without ``k5``) and, for
    ts > 0, the scene's K6 maps: (stack, k6 or None, the stack's rows with
    the factors expanded to cells after them)."""
    rng = np.random.RandomState(ts)
    base = rng.normal(0, 1, (2, 12 if k5 else 0, IS, IS)).astype(np.float32)
    if not ts:
        return base, None, base
    k6 = _k6_maps(sc, ts)
    fac = k6.factors(torch.as_tensor(sc['fim']))
    return (base, k6, np.concatenate(
        [base, ttex.texture_channels_cells(fac, ts).numpy()], axis=1))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize('ts', [0, 2, 4])
def test_face_reduce_plain_matches_segment_sum(scene, ts):
    """Per-face sums (the K6 cells built from the maps for ts > 0) against
    jax.ops.segment_sum of the expanded rows; faces that win no pixel get
    exact zeros."""
    sc = scene
    nf = sc['faces'].shape[1]
    stack, k6, rows = _reduce_stack(sc, ts)
    got = backward_cuda.face_reduce_plain(
        torch.as_tensor(stack), torch.as_tensor(sc['fim']), nf, k6).numpy()
    seg = np.asarray(jbwd.face_segments(None, jnp.zeros((2, nf)),
                                        jnp.asarray(sc['fim'])))
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(rows.transpose(0, 2, 3, 1).reshape(-1, rows.shape[1])),
        jnp.asarray(seg.reshape(-1)), num_segments=2 * nf + 1))[:-1]
    assert got.shape == (2 * nf, 12 + ts ** 3 * 3)
    _close(got, want, 1e-5, 1e-6)
    won = np.zeros(2 * nf, bool)
    won[seg[seg < 2 * nf]] = True
    assert (~won).sum() > 0 and np.all(got[~won] == 0)


def _factor_stack_route(stack, fim, nf, k6):
    """The reduction as it ran when the stack carried the K6 factors: the
    factor channels written after the K5 channels, the stack's last
    ``ts^2 + ts + 3`` channels expanded to cells, ``index_add_``."""
    ts = k6.ts
    naux = ts * ts + ts + 3
    full = torch.cat([stack, k6.factors(fim)], dim=1)
    C = full.shape[1]
    full = torch.cat([full[:, :C - naux],
                      ttex.texture_channels_cells(full[:, C - naux:], ts)],
                     dim=1)
    c_out = full.shape[1]
    rows = full.permute(0, 2, 3, 1).reshape(-1, c_out)
    seg = tbwd.face_segments(fim, nf).reshape(-1)
    out = torch.zeros((stack.shape[0] * nf + 1, c_out))
    return out.index_add_(0, seg, rows)[:-1]


@pytest.mark.parametrize('k5', [True, False], ids=['k5', 'k6_only'])
@pytest.mark.parametrize('ts', [1, 2, 3, 4])
def test_face_reduce_builds_the_factors_as_the_stack_carried_them(scene, ts,
                                                                  k5):
    """``face_reduce`` fed the K5 stack (or none) and the maps gives the
    bits of the route in which the stack carried the factor channels."""
    sc = scene
    nf = sc['faces'].shape[1]
    stack, k6, _ = _reduce_stack(sc, ts, k5)
    stack, fim = torch.as_tensor(stack), torch.as_tensor(sc['fim'])
    got = backward_cuda.face_reduce(stack, fim, nf, k6)
    want = _factor_stack_route(stack, fim, nf, k6)
    assert got.shape == (2 * nf, (12 if k5 else 0) + 3 * ts ** 3)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(want[:, -3 * ts ** 3:].abs().max()) > 0


class _FakeFactorReduce:
    """Stands in for ``csrc/face_reduce.cu``'s ``nr_face_reduce`` on CPU
    tensors: reads the stack and the four maps behind the pointers and
    strides it is handed, builds each pixel's K6 factors in the kernel's
    order of float32 operations, and sums the rows per face in pixel
    order, as ``face_reduce_plain``'s ``index_add_`` does."""

    launches = 0

    @staticmethod
    def nr_face_reduce_tile():
        return 16

    @staticmethod
    def _strided(address, strides, shape):
        span = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
        buf = np.ctypeslib.as_array((ctypes.c_float * span).from_address(
            address))
        return np.lib.stride_tricks.as_strided(
            buf, shape, [4 * s for s in strides])

    @classmethod
    def nr_face_reduce(cls, stack, fim, start, ids, order, first, bs, nf,
                       is_, C, ts, maps, strides, hi, partial, out, stream):
        cls.launches += 1
        f32 = np.float32
        shape4 = (bs, 3, is_, is_)
        z, w, d, g = (cls._strided(maps[i], strides[4 * i:4 * i + 4], s)
                      for i, s in enumerate((shape4, shape4,
                                             (bs, 1, is_, is_), shape4)))
        face = np.ctypeslib.as_array((ctypes.c_int * (bs * is_ * is_))
                                     .from_address(fim)).reshape(bs, is_,
                                                                 is_)
        # uncovered pixels divide by z = 0; only covered rows are summed
        with np.errstate(all='ignore'):
            tif = (w * f32(ts - 1)) * (d / z)
            tif = np.minimum(np.maximum(tif, f32(0)), f32(hi))
            lo = tif.astype(np.int32)
            frac = tif - lo.astype(f32)
            hat = [[np.where(lo[:, k] == j, f32(1) - frac[:, k], f32(0))
                    + np.where(lo[:, k] + 1 == j, frac[:, k], f32(0))
                    for j in range(ts)] for k in range(3)]
            p01 = [x0 * x1 for x0 in hat[0] for x1 in hat[1]]
            cells = [(p * a) * g[:, c] for p in p01 for a in hat[2]
                     for c in range(3)]
        cols = [] if C == 0 else list(np.ctypeslib.as_array(
            (ctypes.c_float * (bs * C * is_ * is_)).from_address(stack))
            .reshape(bs, C, is_, is_).transpose(1, 0, 2, 3))
        rows = np.stack(cols + cells, -1).reshape(-1, C + 3 * ts ** 3)
        covered = face.reshape(-1) >= 0
        seg = (np.arange(bs)[:, None, None] * nf + face).reshape(-1)
        sums = np.zeros((bs * nf, rows.shape[1]), f32)
        np.add.at(sums, seg[covered], rows[covered])
        np.ctypeslib.as_array((ctypes.c_float * sums.size).from_address(
            out))[:] = sums.reshape(-1)
        return 0


@pytest.mark.parametrize('k5', [True, False], ids=['k5', 'k6_only'])
@pytest.mark.parametrize('ts', [2, 4])
def test_face_reduce_card_route_hands_the_kernel_the_maps(scene,
                                                          monkeypatch, ts,
                                                          k5):
    """The card route hands the kernel the maps as they lie (z and
    weights channel-leading views of NHWC maps, the rgb gradient an NHWC
    view of NCHW memory), their strides, ts and the clamp's limit; the
    kernel's order of operations, mirrored by the fake, gives the plain
    version's bits.  One launch, counted with ``k6.in_reduce``."""
    sc = scene
    nf = sc['faces'].shape[1]
    stack, _, _ = _reduce_stack(sc, ts, k5)
    nchw = torch.as_tensor(sc['grgb']).permute(0, 3, 1, 2).contiguous()
    k6 = _k6_maps(sc, ts, nchw.permute(0, 2, 3, 1))
    stack, fim = torch.as_tensor(stack), torch.as_tensor(sc['fim'])
    bins = dict(zip(('start', 'ids', 'order', 'first'),
                    forward_cuda.bin_faces(TSet(image_size=IS, eps=EPS),
                                           torch.as_tensor(sc['faces']),
                                           16)), tile=16)
    want = backward_cuda.face_reduce_plain(stack, fim, nf, k6)
    _FakeFactorReduce.launches = 0
    torch_fakes.fake_card(monkeypatch, backward_cuda, _FakeFactorReduce)
    tracing.reset()
    try:
        got = backward_cuda.face_reduce(stack, fim, nf, k6, bins)
        counts = tracing.counts()
    finally:
        tracing.reset()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _FakeFactorReduce.launches == 1
    assert counts == {'launch.face_reduce': 1, 'k6.in_reduce': 1,
                      'work.k6_cells': 2 * nf * ts ** 3}


@pytest.mark.parametrize('ts', [0, 2])
def test_tile_pairs_sum_to_face_reduce(scene, ts):
    """The card's reduction bookkeeping, on CPU tensors: the forward's tile
    lists (``bin_faces`` at the kernel's 16-pixel tile) hold every covered
    pixel's winner, the slot ``torch.searchsorted`` finds in the tile's
    list points back at it, and the plain two-level sum (pixels into the
    partial rows ``order[start[t] + k]``, then each face's rows
    ``first[f]:first[f + 1]``) equals ``face_reduce_plain``."""
    sc = scene
    bs, nf = sc['faces'].shape[:2]
    tile = 16
    nt_ = IS // tile
    start, ids, order, first = forward_cuda.bin_faces(
        TSet(image_size=IS, eps=EPS), torch.as_tensor(sc['faces']), tile)
    assert start.dtype == ids.dtype == order.dtype == first.dtype \
        == torch.int32
    assert first.shape == (bs * nf + 1,) and int(first[-1]) == ids.shape[0]
    fim = torch.as_tensor(sc['fim'])
    covered = fim >= 0
    yy, xx = torch.meshgrid(torch.arange(IS), torch.arange(IS),
                            indexing='ij')
    t = ((torch.arange(bs)[:, None, None] * nt_ + yy // tile) * nt_
         + xx // tile)[covered]
    winner = fim[covered].long()
    # tile-major pairs in ascending (tile, face) order: one search finds
    # each pixel's slot in its own tile's list
    pair_tile = torch.repeat_interleave(torch.arange(bs * nt_ * nt_),
                                        torch.diff(start.long()))
    pos = torch.searchsorted(pair_tile * nf + ids.long(), t * nf + winner)
    k = pos - start.long()[t]
    assert bool((k >= 0).all()) and bool((pos < start.long()[t + 1]).all())
    assert bool((ids.long()[start.long()[t] + k] == winner).all())
    assert covered.sum() > 500

    stack, k6, rows = _reduce_stack(sc, ts)
    rows = torch.as_tensor(rows).permute(0, 2, 3, 1)[covered]
    partial = torch.zeros((ids.shape[0], rows.shape[1])).index_add_(
        0, order.long()[start.long()[t] + k], rows)
    face_of_row = torch.repeat_interleave(torch.arange(bs * nf),
                                          torch.diff(first.long()))
    got = torch.zeros((bs * nf, rows.shape[1])).index_add_(0, face_of_row,
                                                           partial)
    want = backward_cuda.face_reduce_plain(torch.as_tensor(stack), fim, nf,
                                           k6)
    _close(got.numpy(), want.numpy(), 1e-5, 1e-6)
    assert np.abs(want.numpy()).max() > 0


@pytest.mark.parametrize('sweep', ['insweep', 'outsweep'])
def test_sweeps_take_permuted_nhwc_views(scene, sweep):
    """rgb and grad rgb go in as the permuted NHWC views that
    ``core._k5_stack`` passes, with the results of contiguous inputs."""
    ts_, _ = _settings('rgb+alpha')
    sc = scene
    t = torch.as_tensor
    rgb, grgb = (t(sc[k]).permute(0, 3, 1, 2) for k in ('rgb', 'grgb'))
    assert not rgb.is_contiguous() and not grgb.is_contiguous()
    fn = getattr(backward_cuda, sweep)
    got = fn(ts_, t(sc['xy']), t(sc['fim']), rgb, grgb, t(sc['galpha']))
    want = fn(ts_, t(sc['xy']), t(sc['fim']), rgb.contiguous(),
              grgb.contiguous(), t(sc['galpha']))
    assert np.abs(want.numpy()).max() > 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize('per_batch', [False, True])
def test_background_gradient_matches_jax(per_batch):
    """Exact background gradient: the sum of the uncovered pixels'
    cotangents, for a static [3] and a per-batch [bs, 3] colour."""
    v = np.tile(np.array([[0.5, 0.5, 1.], [-0.5, -0.5, 1.], [0.5, -0.5, 1.]],
                         np.float32), (3, 1, 1, 1))
    tx = np.zeros((3, 1, 2, 2, 2, 3), np.float32)
    bg = (np.eye(3, dtype=np.float32) if per_batch
          else np.array([0.25, 0.5, 0.75], np.float32))
    w = np.random.RandomState(1).normal(0, 1, (3, 3, 16, 16)).astype(
        np.float32)
    want = np.asarray(jax.grad(lambda b: jnp.sum(nr.rasterize(
        v, tx, image_size=16, anti_aliasing=False,
        background_color=b) * w))(jnp.asarray(bg)))
    bt = torch.tensor(bg, requires_grad=True)
    (nt.rasterize(torch.as_tensor(v), torch.as_tensor(tx), image_size=16,
                  anti_aliasing=False, background_color=bt)
     * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(bt.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).max() > 0


def _hardcoded_renderer():
    r = nt.Renderer()
    r.image_size = IS
    r.anti_aliasing = False
    r.perspective = False
    r.light_intensity_ambient = 1.0
    r.light_intensity_directional = 0.0
    return r


def _port_grad(vertices, pyi, pxi, on_face, mode):
    """d(loss)/d(vertices) of the reference's backward test cases
    (tests/test_rasterize*.py), through torch.autograd."""
    r = _hardcoded_renderer()
    v, f, t = utils.to_minibatch((np.array(vertices, np.float32),
                                  np.array([[0, 1, 2]], np.int32),
                                  np.ones((1, 4, 4, 4, 3), np.float32)))
    vt, ft, tt = nt.arrays_from_numpy(v, f, t, device='cpu')
    vt.requires_grad_()
    if mode == 'rgb':
        images = r.render(vt, ft, tt).mean(1)
    else:
        images = r.render_silhouettes(vt, ft)
    x = images[:, pyi, pxi]
    loss = x.abs().sum() if on_face else (x - 1).abs().sum()
    loss.backward()
    return vt.grad.numpy()


@pytest.mark.parametrize('case', [0, 1])
@pytest.mark.parametrize('mode', ['sil', 'rgb'])
def test_hardcoded_gradient_cases(case, mode):
    """tests/test_rasterize.py:79, :257 (rgb) and
    tests/test_rasterize_silhouettes.py:53, :64 (silhouettes)."""
    vertices, pyi, pxi, on_face = CASES[case]
    got = _port_grad(vertices, pyi, pxi, on_face, mode)
    want = utils.to_minibatch((np.array(HARDCODED[(case, 'sil')],
                                        np.float32),))[0]
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-5)


@pytest.mark.parametrize('case', [0, 1])
@pytest.mark.parametrize('mode', ['sil', 'rgb'])
def test_float64_parity(case, mode):
    """The float64 numpy K5 pipeline of test_grad_parity64 (rgb renders use
    rasterizer_eps 1e-3, silhouettes the rasterizer default 1e-4)."""
    vertices, pyi, pxi, on_face = CASES[case]
    want = _reference_grad64(vertices, pyi, pxi, on_face, mode)
    got = _port_grad(vertices, pyi, pxi, on_face, mode)[2]
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=np.abs(want).max() * 1e-4)
