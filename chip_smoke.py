"""Smoke run of the PyTorch port (neural_renderer_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; progress goes to stdout):
  1. the card: ``torch.cuda.is_available()``, name and power limit;
  2. build the CUDA kernels from ``neural_renderer_torch/csrc`` (six
     sources: the five TPU kernels' counterparts, the forward's setup and
     binning and the segmented sum; one nvcc each, all started together)
     and print ptxas' register and shared-memory report;
  3. the forward kernel against its plain PyTorch version on the card,
     inputs from ``--seed``: random 64^2 scenes (no textures, ts 2/3/4) and
     the teapot at a 512^2 raster (bs 4 ts 2, the golden batch at ts 4, and
     the main path's bs 32 ts 2); face_index_map must match exactly, the
     other maps within the stated tolerances; both timed at the main path's
     shape.  On every scene the device setup and binning
     (``forward_cuda.bin_setup``) against ``_face_records``,
     ``_index_records`` and ``bin_faces``: records bit-equal, ``start``,
     ``ids``, ``order`` and ``first`` equal, repeat runs bitwise equal;
     timed alone at the main path's shape;
  4. the forward-only path: ``Renderer().render`` on the teapot at batch 32,
     256^2 with anti-aliasing (512^2 raster), ts 2, over the 8 bench
     azimuths, counting kernel launches, then one more sweep under
     torch.profiler for the device operations per forward call;
  5. the golden check: the reference off-axis view (eye [1, 1, -2.7]) at ts
     4 against ``tests/data/teapot_aa_rgb_fingerprint.npz`` (atol 1e-5);
  6. the backward kernels against their plain versions on the card: random
     64^2 scenes (rgb + alpha, alpha only, rgb + alpha + depth), the teapot
     at 512^2 (bs 4 ts 2), the golden batch at ts 4 (the all-zero meshes'
     rows must be exactly 0) and the main path's bs 32 ts 2.  In-sweep: 0
     mismatches.  Out-sweep (written, and added to the in-sweep as the main
     path runs it) and per-face reduction (on the forward's tile lists):
     |err| <= 1e-4 x the channel's (column's) max |value|.  Every kernel
     result of a repeated run is bitwise equal.  All three timed at the main
     path's shape: the out-sweep as the main path calls it, added to the
     K5 slice of the stack, with the phase's random output gradients and
     with those of ``sum(image)`` through the 2x2 pool, and in write mode;
     the reduction as one call and each of its two passes alone;
  7. the main path: a training step, forward plus ``sum(image).backward()``
     with respect to vertices and textures, at batch 32, 256^2 AA, ts 2,
     one step per bench azimuth after one warm-up step, counting launches
     of every kernel (at least one per kernel per step), then one more
     sweep under torch.profiler: device time and device operations per
     step, the card's idle share and the kernels' device times; two steps
     of one eye must give bitwise-equal vertex and texture gradients;
  8. a trainer: a ``Mesh`` of the teapot (ts 2), built on the card by
     ``Mesh.from_obj`` itself, fitted by ``Adam`` for 10 steps at batch 32
     (the 8 azimuths x 4), 256^2 AA, L2 against renders of a shifted mesh;
     the loss must fall;
  9. gradient anchors: the four hard-coded cases of tests/test_rasterize.py
     and tests/test_rasterize_silhouettes.py at rtol 1e-2, and the teapot
     silhouette gradient against tests/data/teapot_grad_fingerprint.npz
     (|err| <= 1e-3 x max |grad|; the plain version on the CPU is within
     2.43e-4 x max);
 10. the index-and-depth kernel against its plain version on the card:
     random 64^2 scenes (plain, with coincident duplicated faces, with
     degenerate faces), the teapot at 512^2 bs 4, the golden batch and the
     main shape (bs 32, 512^2); 0 index mismatches, a bit-equal depth plane
     and bitwise-equal repeat runs, and the setup and binning checked as in
     phase 3; timed at the main shape, alone and as a call;
 11. the tune path at full width, the JAX bench's tuned workload:
     ``tune`` on the teapot at batch 32, 256^2 AA, ts 2, over the 8 bench
     azimuths with ``margin=1.0`` (at least one index-kernel launch per
     azimuth); its dict must cover ``measure_scene`` of every azimuth;
     ``measure=True`` must return {} and leave ``perf_overrides`` as it was;
 12. a large mesh: the 163,840-face icosphere (subdiv 6, fill_back), the
     setup and binning and the index kernel against their plain versions at
     bs 1 on 512^2 (0 mismatches), then a ``render_silhouettes`` training
     step at batch 4, 256^2 AA, over the 8 azimuths: every kernel launches,
     the vertex gradient is finite and non-zero, images/s printed;
 13. long lines: on a sparse random scene at bs 1, the out-sweep at a
     4096^2 raster for ``render_silhouettes`` (alpha) and ``render`` (rgb),
     written and accumulated, against its plain version (1e-4 x channel
     max) with bitwise-equal repeat runs, then a training step of each at
     2048^2 AA; training steps of ``render`` at a 2800 raster and
     ``render_rgbad`` at an 8192 raster; every step launches the out-sweep
     and repeats bit for bit.  At 512^2 the crossing list is forced into
     rounds (``backward_cuda._outsweep`` with a small ``cap``), with the
     planes staged and read from device memory, against the plain version;
 14. deterministic scatters: a ts 8 training step at bs 4 twice (vertex and
     texture gradients bitwise equal); the ts 8 texture gradient
     (``texture.grad_textures``: its rows sorted by cell, then summed by
     segments) against its plain version on CPU copies of the same maps
     (1e-6 x column max), and the sort of its rows, the segmented sum and
     the whole gradient timed at bs 4 and at bs 32; the segmented sum
     (``csrc/segment_sum.cu``) against its plain version (1e-6 x column
     max) at the main path's vertex scatter and at the ts 8 texture
     scatter's scale, timed with its plain version and ``index_add_``;
 15. parallel on one card: 2 ranks spawned over gloo (``file://``
     rendezvous in a temporary directory), each on ``cuda:0``: the
     face-sharded ``render_rgbad`` of the main path's workload at ts 2 and
     ts 8 bit-equal to the one-process render of the shard-order list,
     texture gradients equal and vertex gradients within rtol 5e-4; the
     rasterizer alone on each rank's slice of the lit face list: images
     bit-equal, texture gradients equal, face gradients within the JAX
     package's face-parallel contract; then 3 data-parallel steps (functional
     ``adam``) whose loss must fall, with equal parameters on both ranks;
 16. spatial face order: one timed forward sweep with
     ``Mesh(spatial_order=True)`` and one without (no claim).

The last stdout line is the JSON device record.  The line before it lists each
of the five kernels with its launches on its path (phase 7 for the first four,
phase 11 for the index kernel), its worst error against the plain version
(the out-sweep's over phases 6 and 13),
its time and the plain version's, its bound (the larger of the bytes it must
move over the card's memory rate and its operations over the f32 rate, from
this run's inputs) and the library side's time where PyTorch has a call for
the function's core: for the per-face reduction, its K6 expansion, the
covered rows' gather and one ``index_add_``, from the kernel's own inputs.
The out-sweep's and the reduction's entries also carry the other timings of
phase 6.  The line before that gives the setup and binning (not a TPU
kernel: the JAX package bins in XLA) with its launches in phase 7, its
times and its bound, and the one before that the segmented sum (not a TPU
kernel either) with its launches in phase 7 (and per step), its device
time per step from phase 7's profile, and phase 14's numbers at the main
path's vertex scatter.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import neural_renderer_torch as nt
from neural_renderer_torch import _build, parallel
from neural_renderer_torch.ops import segments
from neural_renderer_torch.rasterize import backward as bwd
from neural_renderer_torch.rasterize import api, backward_cuda, core
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize import texture as tex
from neural_renderer_torch.rasterize.config import RasterizeSettings

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, 'tests', 'data')
BATCH = 32
OUT_SIZE = 256                 # the main path's output; its raster is 2x
RASTER = 2 * OUT_SIZE
AZIMUTHS = [float(a) for a in range(0, 360, 45)]
DISTANCE, ELEVATION = 2.732, 30.0
KERNELS = ('forward_shaded', 'forward_index', 'backward_sweeps',
           'face_reduce', 'bin_faces', 'segment_sum')
# the kernels a training step launches (the index kernel serves tune)
TRAINING_KERNELS = ('forward_shaded', 'insweep', 'outsweep', 'face_reduce',
                    'bin_faces', 'segment_sum')
# the setup and binning's device operations, by the substrings of their
# profiler names: its own kernels, CUB's scans and the counters' memset
BINNING_OPS = ('bin_setup_kernel', 'bin_finish_kernel', 'bin_fill_kernel',
               'DeviceScan', 'Memset (Device)')

# the card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# device memory bytes/s and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations the z test needs per (pixel, binned face) pair at the
# least: three edge tests of two differences, two products and a compare
PAIR_OPS = 15
# per out-sweep position at the least: dg, the rgb value difference times
# the gradient summed over 3 channels (3 sub, 3 mul, 2 add), the offset
# q - d1_cross (1), and per term its product, +-eps, its division and its
# add to the sum (2 x 4)
SWEEP_POS_OPS = 17

# kernel vs plain: the same separately rounded f32 operations in the same
# order, except that sums may be taken in another order
RTOL, ATOL = 1e-5, 1e-6
# rgb: the 8 corner terms are summed per channel in the same order, but the
# texel weights inherit the ulp noise of tif
RGB_RTOL, RGB_ATOL = 1e-4, 1e-5
# out-sweep and per-face sums: another summation order than torch's, over
# up to is terms of one sign (out-sweep) or a face's pixels (reduction)
SUM_TOL = 1e-4
# the grad fingerprint was captured on a TPU; the plain version on the CPU
# is within 2.43e-4 x max |grad| of it
FINGERPRINT_TOL = 1e-3

# the segmented sum against its plain version (index_add_): another
# summation order, held to 1e-6 x the column's max |value|
SEGMENT_TOL = 1e-6
# a long line's crossing list forced into rounds at 512^2
FORCED_CAPS = (5, 64)
# the long-line phase's output size (AA doubles the raster)
LONG_OUT = 2048
# the two ranks of the parallel phase, sharing the one card over gloo
RANKS = 2
RANK_TIMEOUT_S = 300

# tests/test_rasterize.py:79, :257 and tests/test_rasterize_silhouettes.py:
# 53, :64: (vertices, pixel y, pixel x, on_face, d loss / d vertices)
ANCHORS = [
    ([[0.8, 0.8, 1.], [0.0, -0.5, 1.], [0.2, -0.4, 1.]], 25, 35, False,
     [[1.6725862, -0.26021874, 0.], [1.41986704, -1.64284933, 0.],
      [0., 0., 0.]]),
    ([[0.8, 0.8, 1.], [-0.5, -0.8, 1.], [0.8, -0.8, 1.]], 40, 50, True,
     [[0.98646867, 1.04628897, 0.], [-1.03415668, -0.10403691, 0.],
      [3.00094461, -1.55173182, 0.]]),
]


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _log(*args):
    print(*args, flush=True)


def _teapot():
    vertices, faces = nt.load_obj(os.path.join(DATA, 'teapot.obj'))
    return vertices, faces


def _reset_launches():
    for counts in (forward_cuda.LAUNCHES, backward_cuda.LAUNCHES,
                   segments.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches():
    return dict(**forward_cuda.LAUNCHES, **backward_cuda.LAUNCHES,
                **segments.LAUNCHES)


def _bound(nbytes, ops):
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _binned_pairs(settings, faces, tile):
    """(pixel, binned face) pairs of the forward kernels: each tile's list
    length times its pixels inside the image."""
    start = forward_cuda.bin_faces(settings, faces, tile)[0]
    is_ = settings.image_size
    nt_ = -(-is_ // tile)
    lengths = (start[1:] - start[:-1]).reshape(-1, nt_, nt_).long()
    edge = torch.full((nt_,), tile, dtype=torch.int64, device=faces.device)
    edge[-1] = is_ - tile * (nt_ - 1)
    return int((lengths * edge[:, None] * edge[None, :]).sum())


def _icosphere(subdiv):
    """Subdivided icosahedron on a sphere of radius 0.9 (the JAX bench's
    large-mesh scene, bench.py:93-122: subdiv 6 -> 81,920 faces; the
    Renderer's fill_back doubles that)."""
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                  [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                  [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        verts, edges, nf = list(v), {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                m = v[a] + v[b]
                edges[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return edges[key]

        for (a, b, c) in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.array(verts), np.array(nf)
    return (v * 0.9).astype(np.float32), f.astype(np.int32)


def _raster_inputs(vertices, faces, textures, eyes, image_size, dev):
    """NDC face coords and lit, fill_back textures for a batch of eyes: the
    Renderer's own pre-raster pipeline, one batch row per eye."""
    bs = len(eyes)
    v = torch.as_tensor(np.tile(vertices[None], (bs, 1, 1)), device=dev)
    f = torch.as_tensor(np.tile(faces[None], (bs, 1, 1)), device=dev)
    t = torch.as_tensor(np.tile(textures[None], (bs,) + (1,) * 5),
                        device=dev)
    r = nt.Renderer()
    r.image_size = image_size
    face_coords = []
    lit = []
    for i, eye in enumerate(eyes):
        r.eye = eye
        fc, tx = r._lit_faces(v[i:i + 1], f[i:i + 1], t[i:i + 1])
        face_coords.append(fc)
        lit.append(tx)
    return torch.cat(face_coords), torch.cat(lit)


def _compare(name, settings, faces, textures):
    """Kernel vs plain on one scene; returns the worst abs error."""
    got = forward_cuda.forward_shaded(settings, faces, textures)
    want = forward_cuda.forward_shaded_plain(settings, faces, textures)
    torch.cuda.synchronize()
    mism = int((got['face_index_map'] != want['face_index_map']).sum())
    covered = int((want['face_index_map'] >= 0).sum())
    worst = 0.0
    errs = {}
    for key in ('depth_map', 'weights', 'xy', 'z', 'rgb'):
        if key not in want:
            continue
        a, b = got[key], want[key]
        err = float((a - b).abs().max())
        errs[key] = err
        worst = max(worst, err)
        rtol, atol = (RGB_RTOL, RGB_ATOL) if key == 'rgb' else (RTOL, ATOL)
        _require(torch.allclose(a, b, rtol=rtol, atol=atol),
                 f'{name}: {key} differs from the plain version by {err}')
    _log(f'compare {name}: face_index_map mismatches {mism} '
         f'(covered {covered}), max abs err {errs}')
    _require(mism == 0, f'{name}: {mism} face_index_map mismatches')
    return worst


def _compare_index(name, settings, faces):
    """Index kernel vs plain on one scene: 0 index mismatches, a bit-equal
    depth plane, bitwise-equal repeat runs; returns the depth's max abs
    error (0.0)."""
    got = forward_cuda.forward_face_index_map(settings, faces)
    again = forward_cuda.forward_face_index_map(settings, faces)
    want = forward_cuda.forward_face_index_map_plain(settings, faces)
    torch.cuda.synchronize()
    mism = int((got[0] != want[0]).sum())
    covered = int((want[0] >= 0).sum())
    err = float((got[1] - want[1]).abs().max())
    _log(f'compare index {name}: face_index_map mismatches {mism} (covered '
         f'{covered}), depth max abs err {err}, depth bit-equal '
         f'{torch.equal(got[1], want[1])}')
    _require(mism == 0, f'{name}: {mism} face_index_map mismatches')
    _require(torch.equal(got[1], want[1]),
             f'{name}: the depth plane differs from the plain version')
    _require(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
             f'{name}: the index kernel\'s repeat run differs')
    _require(covered > 0, f'{name}: nothing covered')
    return err


def _bits_equal(a, b):
    """Bit for bit, with any NaN equal to any NaN (torch.equal has NaN !=
    NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def _compare_bins(name, settings, faces):
    """The device setup and binning against its plain version on one scene,
    at the forward kernels' tile: both records bit-equal, the four lists
    equal, a repeat run bitwise equal.  Returns the number of pairs."""
    tile = forward_cuda._kernel().nr_forward_shaded_tile()
    _require(forward_cuda._index_kernel().nr_forward_index_tile() == tile,
             'the two forward kernels bin at different tiles')
    records = ('rec', 'irec')
    got = forward_cuda.bin_setup(settings, faces, tile, records)
    again = forward_cuda.bin_setup(settings, faces, tile, records)
    want = forward_cuda.bin_setup_plain(settings, faces, tile, records)
    torch.cuda.synchronize()
    for key in records:
        _require(_bits_equal(got[key], want[key]),
                 f'{name}: device {key} differs from the plain version')
        _require(_bits_equal(got[key], again[key]),
                 f'{name}: the binning\'s repeat run differs in {key}')
    for key in ('start', 'ids', 'order', 'first'):
        _require(torch.equal(got[key], want[key]),
                 f'{name}: device {key} differs from bin_faces')
        _require(torch.equal(got[key], again[key]),
                 f'{name}: the binning\'s repeat run differs in {key}')
    pairs = int(got['ids'].shape[0])
    lengths = (got['start'][1:] - got['start'][:-1]).long()
    _log(f'compare binning {name}: records (18 and 28 floats) bit-equal, '
         f'start/ids/order/first equal to bin_faces, repeat run bitwise '
         f'equal; {pairs} (tile, face) pairs, '
         f'{int((lengths > 0).sum())} of {lengths.numel()} tiles non-empty, '
         f'longest list {int(lengths.max())}')
    return pairs


def _time_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _kernel_device_ms(fn, reps, kernel_name):
    """Device time per call of the CUDA kernels whose name contains
    ``kernel_name`` (a substring, or a tuple of them; summed over the
    kernels one call launches), from torch.profiler: each kernel's mean
    duration over the launches the profiler caught, which need not be all
    ``reps`` of them; None where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    patterns = ((kernel_name,) if isinstance(kernel_name, str)
                else kernel_name)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(p in ev.key for p in patterns) and ev.count:
            total += getattr(ev, 'device_time_total',
                             getattr(ev, 'cuda_time_total', 0.0)) / ev.count
    return total / 1000.0 if total > 0 else None


# kernels whose device time the training-step profile reports, by the
# substring of their names
PROFILED = {'forward_shaded': 'shaded_kernel', 'insweep': 'insweep_kernel',
            'outsweep': 'outsweep_', 'face_reduce': 'face_reduce_',
            'segment_sum': 'segment_sum_kernel'}


def _step_profile(step, eyes):
    """One sweep of ``step`` over ``eyes`` under torch.profiler: (device ms
    per step, the sum of the card's kernel and copy durations; profiled
    wall ms per step; {kernel: mean device ms per launch, one launch per
    step}; {'kernels', 'copies', 'memsets': device operations per step}),
    or None where the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for eye in eyes:
            step(eye)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = 0.0
    by = {k: [0.0, 0, set()] for k in PROFILED}   # us, events, kernels
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        total += us
        for name, pattern in PROFILED.items():
            if pattern in ev.name:
                by[name][0] += us
                by[name][1] += 1
                by[name][2].add(ev.name)
    if total <= 0:
        return None
    n = len(eyes)
    # per launch: the mean over the events caught, times the kernels one
    # launch runs (face_reduce's two passes)
    return (total / 1e3 / n, wall * 1e3 / n,
            {k: us / count * len(kernels) / 1e3 if count else 0.0
             for k, (us, count, kernels) in by.items()},
            _op_counts(prof, n))


def _op_counts(prof, n):
    """{'kernels', 'copies', 'memsets': device operations per call} of a
    profile of ``n`` calls."""
    from torch.autograd import DeviceType
    ops = {'kernels': 0, 'copies': 0, 'memsets': 0}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ops['copies' if 'Memcpy' in ev.name else
                'memsets' if 'Memset' in ev.name else 'kernels'] += 1
    return {k: v / n for k, v in ops.items()}


def _device_ops(fn, reps=5):
    """Device operations per call of ``fn``, from torch.profiler (which
    may drop an event now and then)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _op_counts(prof, reps)


def _fmt_ops(ops):
    return (f'{sum(ops.values()):.1f} device operations ({ops["kernels"]:.1f} '
            f'kernels, {ops["copies"]:.1f} copies, {ops["memsets"]:.1f} '
            'memsets)')


def _fmt_ms(x):
    return 'not measured' if x is None else f'{x:.3f} ms'


def _sum_check(name, got, want, axis):
    """|got - want| <= SUM_TOL x max |want| per slice along ``axis``;
    returns (max abs err, worst err / channel max)."""
    dims = [d for d in range(want.ndim) if d != axis]
    scale = want.abs().amax(dim=dims, keepdim=True)
    err = (got - want).abs()
    _require(bool(torch.isfinite(got).all()), f'{name}: non-finite values')
    _require(bool((err <= SUM_TOL * scale).all()),
             f'{name}: differs from the plain version by up to '
             f'{float(err.max())} (tolerance {SUM_TOL} x channel max)')
    ratio = float((err / scale.clamp(min=1e-30)).max())
    return float(err.max()), ratio


def _bwd_scene(settings, faces, textures, rng, dev):
    """The forward maps of one scene (through the forward kernel) and
    random output gradients from ``rng``."""
    bs, nf = faces.shape[:2]
    if textures is None:
        textures = torch.zeros((bs, nf, 1, 1, 1, 3), device=dev)
    rgb, _, _, maps = core._forward_all(settings, faces, textures,
                                        torch.zeros(3, device=dev))
    maps['rgb'] = rgb if settings.return_rgb else None
    is_ = settings.image_size

    def g(*shape):
        return torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                               device=dev)

    grads = dict(g_rgb=g(bs, is_, is_, 3), g_alpha=g(bs, is_, is_),
                 g_depth=g(bs, is_, is_))
    return maps, grads


def _sum_image_grads(bs, is_, dev):
    """The output gradients of ``sum(image)`` as autograd hands them to
    the rasterizer's rgb ``[bs, is, is, 3]``: through the vertical flip and
    the 2x2 mean pool of ``api._render_pass``."""
    x = torch.zeros((bs, is_, is_, 3), device=dev, requires_grad=True)
    image = api._avg_pool_2x2(torch.flip(x.permute(0, 3, 1, 2), dims=[2]))
    g_rgb, = torch.autograd.grad(image.sum(), x)
    return dict(g_rgb=g_rgb, g_alpha=None, g_depth=None)


def _sweep_args(settings, maps, grads):
    """The sweeps' operands as ``core._k5_stack`` passes them: rgb and grad
    rgb as permuted NHWC views."""
    rgb = grgb = ga = None
    if settings.return_rgb:
        rgb = maps['rgb'].permute(0, 3, 1, 2)
        grgb = grads['g_rgb'].permute(0, 3, 1, 2)
    if settings.return_alpha:
        ga = grads['g_alpha']
    return (settings, maps['xy'], maps['face_index_map'], rgb, grgb, ga)


def _accumulated(args):
    """The K5 channels as ``core._k5_stack`` makes them: the in-sweep, then
    the out-sweep added in place (``accumulate=True``)."""
    acc = backward_cuda.insweep(*args)
    return backward_cuda.outsweep(*args, out=acc, accumulate=True)


def _channel_stack(settings, maps, grads, nf, ts):
    k5 = settings.return_rgb or settings.return_alpha
    k6 = ts if settings.return_rgb and ts <= core.MAX_FACTOR_TS else 0
    stack = core.channel_stack(settings, maps, grads['g_rgb'],
                               grads['g_alpha'], grads['g_depth'], k5,
                               settings.return_depth, k6)
    return stack, k6


def _compare_backward(name, settings, maps, grads, nf, ts, worst):
    """The three backward kernels against their plain versions on one
    scene, and each kernel's repeat run bitwise equal; updates ``worst``
    (max abs error per kernel) and returns the per-face sums."""
    fim = maps['face_index_map']
    msg = [f'compare backward {name}:']
    if settings.return_rgb or settings.return_alpha:
        args = _sweep_args(settings, maps, grads)
        got = backward_cuda.insweep(*args)
        again = backward_cuda.insweep(*args)
        want = want_in = backward_cuda.insweep_plain(*args)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        nonzero = int((want != 0).sum())
        _require(bool(torch.equal(got, again)), f'{name}: insweep repeat '
                 'run differs')
        _require(mism == 0, f'{name}: insweep {mism} mismatches')
        worst['insweep'] = max(worst['insweep'],
                               float((got - want).abs().max()))
        msg.append(f'insweep mismatches {mism} (nonzero {nonzero});')

        got = backward_cuda.outsweep(*args)
        again = backward_cuda.outsweep(*args)
        want = backward_cuda.outsweep_plain(*args)
        torch.cuda.synchronize()
        _require(bool(torch.equal(got, again)), f'{name}: outsweep repeat '
                 'run differs')
        err, ratio = _sum_check(f'{name} outsweep', got, want, 1)
        # the main path's mode: added to the in-sweep's channels in place
        acc, acc2 = _accumulated(args), _accumulated(args)
        torch.cuda.synchronize()
        _require(bool(torch.equal(acc, acc2)), f'{name}: outsweep '
                 'accumulate repeat run differs')
        err_acc, ratio_acc = _sum_check(f'{name} outsweep accumulate', acc,
                                        want_in + want, 1)
        worst['outsweep'] = max(worst['outsweep'], err, err_acc)
        msg.append(f'outsweep max abs err {err} ({ratio:.3g} x channel '
                   f'max, nonzero {int((want != 0).sum())}), accumulated '
                   f'on the in-sweep {err_acc} ({ratio_acc:.3g} x);')

    stack, k6 = _channel_stack(settings, maps, grads, nf, ts)
    got = backward_cuda.face_reduce(stack, fim, nf, k6, maps['bins'])
    stack2, _ = _channel_stack(settings, maps, grads, nf, ts)
    again = backward_cuda.face_reduce(stack2, fim, nf, k6, maps['bins'])
    want = backward_cuda.face_reduce_plain(stack, fim, nf, k6)
    torch.cuda.synchronize()
    _require(bool(torch.equal(stack, stack2)), f'{name}: channel stack '
             'repeat run differs')
    _require(bool(torch.equal(got, again)), f'{name}: face_reduce repeat '
             'run differs')
    err, ratio = _sum_check(f'{name} face_reduce', got, want, 1)
    worst['face_reduce'] = max(worst['face_reduce'], err)
    msg.append(f'face_reduce [{stack.shape[1]} ch -> {got.shape[1]} cols] '
               f'max abs err {err} ({ratio:.3g} x column max); repeat '
               'runs bitwise equal')
    _log(' '.join(msg))
    return got


def _anchor_grad(vertices, pyi, pxi, on_face, mode, dev):
    r = nt.Renderer()
    r.image_size = 64
    r.anti_aliasing = False
    r.perspective = False
    r.light_intensity_ambient = 1.0
    r.light_intensity_directional = 0.0
    v = np.zeros((4, 3, 3), np.float32)
    v[2] = vertices
    f = np.zeros((4, 1, 3), np.int64)
    f[2] = [0, 1, 2]
    vt, ft, tt = nt.arrays_from_numpy(
        v, f, np.ones((4, 1, 4, 4, 4, 3), np.float32), dev)
    vt.requires_grad_()
    if mode == 'rgb':
        images = r.render(vt, ft, tt).mean(1)
    else:
        images = r.render_silhouettes(vt, ft)
    x = images[:, pyi, pxi]
    loss = x.abs().sum() if on_face else (x - 1).abs().sum()
    loss.backward()
    return vt.grad.cpu().numpy()


def _sparse_scene(rng, nf):
    """A sparse random scene: ``nf`` small triangles, each with its own
    three vertices, scattered over the view (the long-line phase's mesh)."""
    centers = rng.uniform(-0.8, 0.8, (nf, 1, 3))
    corners = centers + rng.uniform(-0.06, 0.06, (nf, 3, 3))
    v = corners.reshape(-1, 3).astype(np.float32)
    f = np.arange(3 * nf, dtype=np.int32).reshape(nf, 3)
    return v, f


def _grad_step(fn, leaves):
    """``fn(*leaves).sum().backward()`` on fresh leaf copies; their
    gradients (None for a None leaf)."""
    leaves = [None if x is None else x.clone().requires_grad_()
              for x in leaves]
    out = fn(*leaves)
    loss = (out.sum() if torch.is_tensor(out)
            else sum(x.sum() for x in out.values()))
    loss.backward()
    return [None if x is None else x.grad for x in leaves]


def _grads_equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def _grads_ok(grads):
    return all(g is None or (bool(torch.isfinite(g).all())
                             and float(g.abs().max()) > 0) for g in grads)


def _face_contract(got, want):
    """The JAX package's face-parallel gradient contract
    (tests/test_face_parallel.py:169-176): under 0.5% of the elements
    differ and all lie within rtol 5e-4, atol 5e-4 x max |want|.  Returns
    (ok, share of elements that differ, max |err| / max |want|)."""
    scale = float(want.abs().max())
    frac = float((got != want).float().mean())
    ok = (frac < 0.005 and scale > 0 and bool(torch.allclose(
        got, want, rtol=5e-4, atol=5e-4 * scale)))
    return ok, frac, float((got - want).abs().max()) / max(scale, 1e-30)


def _shard_order(faces, tex, world):
    """The one-process face list (and textures) that a face-sharded render
    over ``world`` ranks with fill_back equals: each rank's slice followed
    by its reversed copy, in rank order."""
    n = faces.shape[1] // world
    parts = [slice(k * n, (k + 1) * n) for k in range(world)]
    f = torch.cat([torch.cat([faces[:, p], faces[:, p].flip(2)], 1)
                   for p in parts], 1)
    t = torch.cat([torch.cat([tex[:, p], tex[:, p].permute(0, 1, 4, 3, 2, 5)],
                             1) for p in parts], 1)
    return f, t


def _rank_checks(rank, world, seed):
    """The parallel phase on one rank (the card shared by all): the
    face-sharded ``render_rgbad`` of the main path's workload at ts 2 and
    ts 8 against the one-process render of the shard-order list, then
    three data-parallel training steps.  Returns a JSON-able dict."""
    group = dist.group.WORLD
    dev = torch.device('cuda', 0)
    vertices, faces = _teapot()
    nf = faces.shape[0]
    eyes = np.array([nt.get_points_from_angles(DISTANCE, ELEVATION, a)
                     for a in AZIMUTHS for _ in range(BATCH // 8)],
                    np.float32)
    v = torch.as_tensor(np.tile(vertices[None], (BATCH, 1, 1)), device=dev)
    f = torch.as_tensor(np.tile(faces[None], (BATCH, 1, 1)).astype(np.int64),
                        device=dev)
    r = nt.Renderer()
    r.image_size = OUT_SIZE
    r.eye = eyes
    one = copy.copy(r)
    one.fill_back = False
    out = dict(rank=rank)
    for ts in (2, 8):
        rng = np.random.RandomState(seed + ts)
        tex = torch.as_tensor(rng.uniform(0, 1, (BATCH, nf, ts, ts, ts, 3))
                              .astype(np.float32), device=dev)
        w = torch.as_tensor(rng.uniform(-1, 1, (BATCH, 3, OUT_SIZE, OUT_SIZE))
                            .astype(np.float32), device=dev)
        fl, tl = parallel.shard_faces(group, f, tex)
        render = parallel.make_face_sharded_render(r, group, 'rgbad')

        def loss(o):
            return ((o['rgb'] * w).sum() + o['alpha'].sum()
                    + o['depth'].sum())

        _reset_launches()
        vl = v.clone().requires_grad_()
        tll = tl.clone().requires_grad_()
        o = render(vl, fl, tll)
        loss(o).backward()
        torch.cuda.synchronize()
        launches = _launches()
        ff, tt = _shard_order(f, tex, world)
        v1 = v.clone().requires_grad_()
        t1 = tt.clone().requires_grad_()
        o1 = one.render_rgbad(v1, ff, t1)
        loss(o1).backward()
        n = nf // world
        part = t1.grad[:, 2 * n * rank:2 * n * (rank + 1)]
        want_t = part[:, :n] + part[:, n:].permute(0, 1, 4, 3, 2, 5)
        # the vertex gradient sums the ranks' partial sums, so it differs
        # from one process's in the last bits of many elements: held to
        # the contract's tolerance, its share of differing elements shown
        _, frac_v, err_v = _face_contract(vl.grad, v1.grad)
        check = dict(
            images_equal=all(bool(torch.equal(o[k], o1[k]))
                             for k in ('rgb', 'alpha', 'depth')),
            textures_equal=bool(torch.equal(tll.grad, want_t)),
            vertices_ok=bool(torch.allclose(
                vl.grad, v1.grad, rtol=5e-4,
                atol=5e-4 * float(v1.grad.abs().max()))),
            vertices_differ=frac_v, vertices_err=err_v,
            texture_grad_max=float(want_t.abs().max()),
            finite=bool(all(torch.isfinite(o[k]).all()
                            for k in ('rgb', 'alpha', 'depth'))),
            launches=launches)
        del o, o1, vl, v1, tll, t1, tt, part, want_t

        # the rasterizer alone on this rank's slice of the lit fill_back
        # list: its face gradient is a slice of one process's
        with torch.no_grad():
            fc, txc = r._lit_faces(v, f, tex)
            # each face beside its fill_back copy, so that every rank's
            # slice holds faces the camera sees (the teapot's own faces
            # face away from it)
            order = torch.arange(fc.shape[1], device=dev).reshape(
                2, -1).t().reshape(-1)
            fc, txc = fc[:, order], txc[:, order]
        part = parallel._rank_slice(group, fc.shape[1])
        opts = (OUT_SIZE, True, r.near, r.far, r.rasterizer_eps,
                r.background_color, True, True, True)
        fcl = fc[:, part].clone().requires_grad_()
        txl = txc[:, part].clone().requires_grad_()
        o = nt.rasterize_rgbad(fcl, txl, *opts, face_group=group)
        loss(o).backward()
        fc1 = fc.clone().requires_grad_()
        tx1 = txc.clone().requires_grad_()
        o1 = nt.rasterize_rgbad(fc1, tx1, *opts)
        loss(o1).backward()
        ok_f, frac_f, err_f = _face_contract(fcl.grad, fc1.grad[:, part])
        check.update(
            raster_images_equal=all(bool(torch.equal(o[k], o1[k]))
                                    for k in ('rgb', 'alpha', 'depth')),
            raster_textures_equal=bool(torch.equal(txl.grad,
                                                   tx1.grad[:, part])),
            faces_ok=ok_f, faces_differ=frac_f, faces_err=err_f)
        out[f'ts{ts}'] = check
        del o, o1, fc, txc, fcl, txl, fc1, tx1, tex

    # data parallel: the vertices and textures of a Mesh-like fit, batch 32
    # split over the ranks, three steps of functional Adam
    rng = np.random.RandomState(seed)
    params = dict(vertices=torch.as_tensor(vertices, device=dev),
                  textures=torch.as_tensor(
                      rng.normal(0, 0.05, (nf, 2, 2, 2, 3)).astype(np.float32),
                      device=dev))
    fit = nt.Renderer()
    fit.image_size = OUT_SIZE
    with torch.no_grad():
        fit.eye = eyes
        shift = torch.tensor([0.05, 0.03, 0.0], device=dev)
        target = fit.render((params['vertices'] + shift)[None].expand(
            BATCH, -1, -1), f, torch.sigmoid(
                -params['textures'])[None].expand(BATCH, *(-1,) * 5))
    faces_t = f[0]

    def loss_fn(p, batch):
        tgt, eye = batch
        n = tgt.shape[0]
        fit.eye = eye
        img = fit.render(p['vertices'][None].expand(n, -1, -1),
                         faces_t[None].expand(n, -1, -1),
                         torch.sigmoid(p['textures'])[None].expand(
                             n, *(-1,) * 5))
        return ((img - tgt) ** 2).sum(dim=(1, 2, 3)).mean()

    init_fn, update_fn = nt.adam(alpha=0.01)
    state = init_fn(params)
    step = parallel.make_data_parallel_train_step(loss_fn, update_fn, group)
    batch = parallel.shard_batch(group, target,
                                 torch.as_tensor(eyes, device=dev))
    losses = []
    for _ in range(3):
        params, state, loss_t = step(params, state, batch)
        losses.append(float(loss_t))
    out['dp'] = dict(losses=losses, rows=int(batch[0].shape[0]),
                     checksum=float(params['vertices'].double().sum()
                                    + params['textures'].double().sum()))
    return out


def _rank_main(rank, world, path, seed):
    """Entry of a spawned rank: gloo over a file rendezvous in ``path``,
    the checks of ``_rank_checks`` written to ``path``/rank<rank>.json."""
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'file://{path}/rendezvous',
                            world_size=world, rank=rank)
    try:
        out = _rank_checks(rank, world, seed)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(path, f'rank{rank}.json'), 'w') as fh:
        json.dump(out, fh)


def _spawn_ranks(world, seed):
    """Run ``_rank_main`` in ``world`` spawned processes on the card and
    return their results; raises if a rank fails or they outlast
    ``RANK_TIMEOUT_S``, and leaves no process behind."""
    with tempfile.TemporaryDirectory() as path:
        ctx = mp.spawn(_rank_main, args=(world, path, seed), nprocs=world,
                       join=False)
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                _require(time.monotonic() < deadline,
                         f'the ranks did not finish in {RANK_TIMEOUT_S} s')
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            with open(os.path.join(path, f'rank{r}.json')) as fh:
                results.append(json.load(fh))
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    rng = np.random.RandomState(args.seed)

    # ---- 1. the card ----
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _log(f'torch {torch.__version__} cuda {torch.version.cuda} '
         f'python {sys.version.split()[0]}')
    _log(f'device: {kind}; nvidia-smi: {smi}')
    _log(smi)

    # ---- 2. build ----
    t0 = time.time()
    built = _build.build_all(KERNELS)
    forward_cuda._kernel()
    forward_cuda._index_kernel()
    forward_cuda._binning()
    backward_cuda._sweeps()
    backward_cuda._reduce()
    segments._kernel()
    _log(f'build: {", ".join(p.name for p, _ in built.values())} in '
         f'{time.time() - t0:.1f} s')
    for name, (_, log) in built.items():
        if log.strip():
            _log(f'[{name}]\n{log.strip()}')

    # ---- 3. forward kernel vs plain ----
    worst = 0.0
    for ts in (None, 2, 3, 4):
        fc = rng.uniform(-0.9, 0.9, (2, 40, 3, 3)).astype(np.float32)
        fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
        tx = (None if ts is None else torch.as_tensor(
            rng.uniform(0, 1, (2, 40, ts, ts, ts, 3)).astype(np.float32),
            device=dev))
        s = RasterizeSettings(image_size=64, eps=1e-3)
        worst = max(worst, _compare(f'random 64^2 nf 40 ts {ts}', s,
                                    torch.as_tensor(fc, device=dev), tx))
        _compare_bins(f'random 64^2 nf 40 ts {ts}', s,
                      torch.as_tensor(fc, device=dev))

    vertices, faces = _teapot()
    nf2 = 2 * faces.shape[0]
    eyes = [nt.get_points_from_angles(DISTANCE, ELEVATION, a)
            for a in AZIMUTHS]
    s512 = RasterizeSettings(image_size=RASTER, eps=1e-3)
    tex2 = rng.uniform(0, 1, (faces.shape[0], 2, 2, 2, 3)).astype(np.float32)
    fc4, tx4 = _raster_inputs(vertices, faces, tex2, eyes[::2], RASTER, dev)
    worst = max(worst, _compare(f'teapot {RASTER}^2 bs 4 ts 2', s512, fc4,
                                tx4))
    _compare_bins(f'teapot {RASTER}^2 bs 4', s512, fc4)

    # the golden batch: rows 0, 1, 3 are all-zero meshes (degenerate faces)
    gold = nt.Renderer()
    gold.eye = [1.0, 1.0, -2.7]
    vz = np.zeros((4,) + vertices.shape, np.float32)
    vz[2] = vertices
    fz = np.zeros((4,) + faces.shape, np.int32)
    fz[2] = faces
    tz = np.zeros((4, faces.shape[0], 4, 4, 4, 3), np.float32)
    tz[2] = rng.uniform(0, 1, tz.shape[1:])
    fcg, txg = gold._lit_faces(*nt.arrays_from_numpy(vz, fz, tz, dev))
    worst = max(worst, _compare(f'golden batch {RASTER}^2 bs 4 ts 4', s512,
                                fcg, txg))
    _compare_bins(f'golden batch {RASTER}^2 bs 4', s512, fcg)

    fc32, tx32 = _raster_inputs(vertices, faces, tex2,
                                [e for e in eyes for _ in range(BATCH // 8)],
                                RASTER, dev)
    worst = max(worst, _compare(
        f'teapot {RASTER}^2 bs {BATCH} ts 2 (main path shape)', s512, fc32,
        tx32))
    _reset_launches()
    forward_cuda.forward_shaded(s512, fc32, tx32)
    _require(_launches()['bin_faces'] == 1,
             'forward_shaded did not bin on the card once')

    def kernel():
        return forward_cuda.forward_shaded(s512, fc32, tx32)

    def plain():
        return forward_cuda.forward_shaded_plain(s512, fc32, tx32)

    ms = _time_ms(kernel, reps=20, warmup=3)
    plain_ms = _time_ms(plain, reps=3)
    ms_again = _time_ms(kernel, reps=20)
    plain_ms_again = _time_ms(plain, reps=3)
    kernel_only = _kernel_device_ms(kernel, 10, 'shaded_kernel')
    _log(f'time at bs {BATCH}, {RASTER}^2, nf {nf2}, ts 2 on {smi}: '
         f'forward_shaded {ms:.3f} / {ms_again:.3f} ms, plain '
         f'{plain_ms:.3f} / {plain_ms_again:.3f} ms (kernel, plain, kernel, '
         f'plain); kernel alone (profiler) {_fmt_ms(kernel_only)}')
    times = {'forward_shaded': (ms, plain_ms)}
    alone = {'forward_shaded': kernel_only}
    library = {}
    pairs32 = _binned_pairs(s512, fc32,
                            forward_cuda._kernel().nr_forward_shaded_tile())
    pixels32 = BATCH * RASTER * RASTER
    # faces and texels read once; 17 words per pixel written
    bounds = {'forward_shaded': _bound(
        4 * (fc32.numel() + tx32.numel()) + 17 * 4 * pixels32,
        PAIR_OPS * pairs32)}
    _log(f'forward_shaded bound at bs {BATCH}, {RASTER}^2: {pairs32} binned '
         f'(pixel, face) pairs; {bounds["forward_shaded"][0]:.4f} ms by '
         f'{bounds["forward_shaded"][1]}')

    # the setup and binning alone, as forward_shaded runs it (the 18-float
    # records), at the main path's shape
    tile = forward_cuda._kernel().nr_forward_shaded_tile()
    tile_pairs32 = _compare_bins(
        f'teapot {RASTER}^2 bs {BATCH} (main path shape)', s512, fc32)

    def binning():
        return forward_cuda.bin_setup(s512, fc32, tile)

    def binning_plain():
        return forward_cuda.bin_setup_plain(s512, fc32, tile)

    b1 = _time_ms(binning, reps=20, warmup=3)
    bp1 = _time_ms(binning_plain, reps=20, warmup=3)
    b2 = _time_ms(binning, reps=20)
    bp2 = _time_ms(binning_plain, reps=20)
    nt32 = -(-RASTER // tile)
    # faces read once; records, first, start, ids and order written once
    bin_bound = _bound(4 * fc32.numel() + 4 * BATCH * nf2 * (18 + 1)
                       + 4 * BATCH * nt32 * nt32 + 2 * 4 * tile_pairs32, 0)
    bin_ops, plain_ops = _device_ops(binning), _device_ops(binning_plain)
    binning_times = dict(ms=b1, plain_ms=bp1,
                         alone_ms=_kernel_device_ms(binning, 10, BINNING_OPS),
                         bound_ms=bin_bound[0], bound_by=bin_bound[1],
                         pairs=tile_pairs32,
                         device_ops=sum(bin_ops.values()),
                         plain_device_ops=sum(plain_ops.values()))
    _log(f'setup + binning at bs {BATCH}, {RASTER}^2, nf {nf2} on {smi}: '
         f'bin_setup {b1:.3f} / {b2:.3f} ms, plain {bp1:.3f} / {bp2:.3f} ms '
         f'(kernel, plain, kernel, plain); its device operations alone '
         f'(profiler) {_fmt_ms(binning_times["alone_ms"])}; bound '
         f'{bin_bound[0]:.4f} ms by {bin_bound[1]} ({tile_pairs32} pairs); '
         f'per call {_fmt_ops(bin_ops)}, plain {_fmt_ops(plain_ops)}')

    # ---- 4. the forward-only path ----
    v = torch.as_tensor(np.tile(vertices[None], (BATCH, 1, 1)), device=dev)
    f = torch.as_tensor(np.tile(faces[None], (BATCH, 1, 1)), device=dev)
    t = torch.ones((BATCH, faces.shape[0], 2, 2, 2, 3), device=dev)
    renderer = nt.Renderer()
    renderer.image_size = OUT_SIZE
    renderer.eye = eyes[0]
    renderer.render(v, f, t)                     # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    images = []
    for eye in eyes:
        renderer.eye = eye
        images.append(renderer.render(v, f, t))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd_launches = _launches()
    for name in ('forward_shaded', 'bin_faces'):
        _require(fwd_launches[name] >= len(eyes),
                 f'forward path launched {name} {fwd_launches[name]} times '
                 f'for {len(eyes)} renders')
    images = torch.stack(images)
    _require(tuple(images.shape) == (len(eyes), BATCH, 3, OUT_SIZE, OUT_SIZE),
             f'unexpected image shape {tuple(images.shape)}')
    _require(bool(torch.isfinite(images).all()), 'non-finite pixels')
    _require(bool((images.flatten(2).amax(-1) > 0.5).all()),
             'an empty teapot row')
    _log(f'forward path: {len(eyes)} renders x batch {BATCH}, {OUT_SIZE}^2 '
         f'AA, ts 2: {elapsed:.4f} s, {len(eyes) * BATCH / elapsed:.2f} '
         f'images/s (forward only) on {smi}; launches {fwd_launches}')

    def render(eye):
        renderer.eye = eye
        return renderer.render(v, f, t)

    prof = _step_profile(render, eyes)
    if prof is None:
        _log('forward profile: the profiler reported no device time '
             '(not measured)')
    else:
        fwd_dev_ms, fwd_wall_ms, _, fwd_ops = prof
        _log(f'forward profile (torch.profiler, one sweep of {len(eyes)} '
             f'renders) on {smi}: per forward call {_fmt_ops(fwd_ops)}, '
             f'device {fwd_dev_ms:.3f} ms; against the unprofiled sweep\'s '
             f'{elapsed * 1e3 / len(eyes):.3f} ms per render the card idles '
             f'{100 * (1 - fwd_dev_ms * len(eyes) / elapsed / 1e3):.1f}% '
             f'(profiled wall {fwd_wall_ms:.3f} ms)')

    # ---- 5. golden ----
    ref = np.load(os.path.join(DATA, 'teapot_aa_rgb_fingerprint.npz'))
    tz1 = np.ones((4, faces.shape[0], 4, 4, 4, 3), np.float32)
    img = gold.render(*nt.arrays_from_numpy(vz, fz, tz1, dev)).cpu().numpy()
    err = float(np.abs(img[2] - ref['image']).max())
    _log(f'golden: AA ts 4 fingerprint max abs err {err} (atol 1e-5); '
         f'zero rows max {float(np.abs(img[[0, 1, 3]]).max())}')
    _require(err <= 1e-5, f'fingerprint differs by {err}')
    _require(np.abs(img[[0, 1, 3]]).max() == 0, 'zero rows not empty')

    # ---- 6. backward kernels vs plain ----
    bworst = dict(insweep=0.0, outsweep=0.0, face_reduce=0.0)
    for mode, flags in (('rgb + alpha', (True, True, False)),
                        ('alpha only', (False, True, False)),
                        ('rgb + alpha + depth', (True, True, True))):
        fc = rng.uniform(-0.9, 0.9, (2, 40, 3, 3)).astype(np.float32)
        fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
        tx = torch.as_tensor(rng.uniform(0, 1, (2, 40, 2, 2, 2, 3)).astype(
            np.float32), device=dev)
        s = RasterizeSettings(image_size=64, eps=1e-3, return_rgb=flags[0],
                              return_alpha=flags[1], return_depth=flags[2])
        maps, grads = _bwd_scene(s, torch.as_tensor(fc, device=dev), tx, rng,
                                 dev)
        _compare_backward(f'random 64^2 nf 40 ts 2 {mode}', s, maps, grads,
                          40, 2, bworst)

    s_all = RasterizeSettings(image_size=RASTER, eps=1e-3)
    maps, grads = _bwd_scene(s_all, fc4, tx4, rng, dev)
    _compare_backward(f'teapot {RASTER}^2 bs 4 ts 2 rgb + alpha + depth',
                      s_all, maps, grads, nf2, 2, bworst)

    s_rgb = RasterizeSettings(image_size=RASTER, eps=1e-3, return_alpha=False,
                              return_depth=False)
    maps, grads = _bwd_scene(s_rgb, fcg, txg, rng, dev)
    sums = _compare_backward(f'golden batch {RASTER}^2 bs 4 ts 4 rgb', s_rgb,
                             maps, grads, nf2, 4, bworst)
    rows = sums.reshape(4, nf2, -1)
    zero_max = float(rows[[0, 1, 3]].abs().max())
    _log(f'golden batch: all-zero meshes\' gradient rows max |value| '
         f'{zero_max}; teapot row max {float(rows[2].abs().max())}')
    _require(zero_max == 0, 'all-zero meshes got gradient')

    maps, grads = _bwd_scene(s_rgb, fc32, tx32, rng, dev)
    _compare_backward(f'teapot {RASTER}^2 bs {BATCH} ts 2 rgb (main path '
                      'shape)', s_rgb, maps, grads, nf2, 2, bworst)

    # the whole rasterizer backward, twice: gradients of the NDC faces and
    # the textures bitwise equal
    def rasterizer_grads():
        fl = fc32.clone().requires_grad_()
        tl = tx32.clone().requires_grad_()
        image = nt.rasterize(fl, tl, OUT_SIZE)
        (image * grads['g_rgb'][:, :OUT_SIZE, :OUT_SIZE].permute(
            0, 3, 1, 2)).sum().backward()
        return fl.grad, tl.grad

    g1, g2 = rasterizer_grads(), rasterizer_grads()
    _require(all(bool(torch.equal(a, b)) for a, b in zip(g1, g2)),
             'the rasterizer backward is not deterministic')
    _log(f'rasterizer backward twice at bs {BATCH} {RASTER}^2: face and '
         'texture gradients bitwise equal (max |grad| '
         f'{float(g1[0].abs().max()):.6g}, {float(g1[1].abs().max()):.6g})')
    del g1, g2
    sweep = _sweep_args(s_rgb, maps, grads)
    stack, k6 = _channel_stack(s_rgb, maps, grads, nf2, 2)
    fim = maps['face_index_map']
    bins = maps['bins']
    # the out-sweep as the main path runs it: added in place to the K5
    # slice of the stack after the in-sweep (a scratch copy, which the
    # repeated timing keeps adding to)
    k5 = stack[:, :12].clone()
    bench = {
        'insweep': (lambda: backward_cuda.insweep(*sweep),
                    lambda: backward_cuda.insweep_plain(*sweep),
                    'insweep_kernel', 20, 3),
        'outsweep': (lambda: backward_cuda.outsweep(*sweep, out=k5,
                                                    accumulate=True),
                     lambda: k5.add_(backward_cuda.outsweep_plain(*sweep)),
                     'outsweep_', 20, 1),
        'face_reduce': (lambda: backward_cuda.face_reduce(stack, fim, nf2, k6,
                                                          bins),
                        lambda: backward_cuda.face_reduce_plain(
                            stack, fim, nf2, k6),
                        'face_reduce_', 20, 3),
    }
    for name, (kern, plain_fn, kname, reps, preps) in bench.items():
        k1 = _time_ms(kern, reps=reps, warmup=2)
        p1 = _time_ms(plain_fn, reps=preps)
        k2 = _time_ms(kern, reps=reps)
        p2 = _time_ms(plain_fn, reps=preps)
        alone[name] = _kernel_device_ms(kern, 5, kname)
        times[name] = (k1, p1)
        _log(f'time at bs {BATCH}, {RASTER}^2, rgb, ts 2 ({stack.shape[1]} '
             f'stack channels) on {smi}: {name} {k1:.3f} / {k2:.3f} ms, '
             f'plain {p1:.3f} / {p2:.3f} ms (kernel, plain, kernel, plain); '
             f'kernel alone (profiler) {_fmt_ms(alone[name])}')

    # the out-sweep with the output gradients of the main path, sum(image)
    # through the 2x2 pool (write mode checked against the plain version),
    # and in write mode with phase 6's random gradients
    sweep_sum = _sweep_args(s_rgb, maps,
                            _sum_image_grads(BATCH, RASTER, dev))
    got = backward_cuda.outsweep(*sweep_sum)
    err, ratio = _sum_check('outsweep sum(image) gradients', got,
                            backward_cuda.outsweep_plain(*sweep_sum), 1)

    def out_sum():
        return backward_cuda.outsweep(*sweep_sum, out=k5, accumulate=True)

    def out_write():
        return backward_cuda.outsweep(*sweep)

    extra = {'outsweep': dict(
        sum_image_ms=_time_ms(out_sum, reps=20, warmup=2),
        sum_image_alone_ms=_kernel_device_ms(out_sum, 5, 'outsweep_'),
        write_mode_ms=_time_ms(out_write, reps=20, warmup=2),
        write_mode_alone_ms=_kernel_device_ms(out_write, 5,
                                              'outsweep_'))}
    bworst['outsweep'] = max(bworst['outsweep'], err)
    o = extra['outsweep']
    _log(f'outsweep at bs {BATCH}, {RASTER}^2, rgb on {smi}: accumulate mode '
         f'with the gradients of sum(image) {o["sum_image_ms"]:.3f} ms, '
         f'alone {_fmt_ms(o["sum_image_alone_ms"])} (write mode vs plain: '
         f'max abs err {err}, {ratio:.3g} x channel max); write mode with '
         f'random gradients {o["write_mode_ms"]:.3f} ms, alone '
         f'{_fmt_ms(o["write_mode_alone_ms"])}')

    def reduce():
        return backward_cuda.face_reduce(stack, fim, nf2, k6, bins)

    extra['face_reduce'] = dict(
        tile_pass_alone_ms=_kernel_device_ms(reduce, 5, 'face_reduce_tile'),
        face_pass_alone_ms=_kernel_device_ms(reduce, 5, 'face_reduce_face'))
    _log(f'face_reduce passes alone (profiler) on {smi}: tile pass '
         f'{_fmt_ms(extra["face_reduce"]["tile_pass_alone_ms"])}, face pass '
         f'{_fmt_ms(extra["face_reduce"]["face_pass_alone_ms"])}, over '
         f'{bins["ids"].shape[0]} (tile, face) pairs')

    # the bounds at this shape: per-pixel inputs count where the function
    # reads them (covered pixels), the face map and the outputs everywhere
    cov = int((fim >= 0).sum())
    channels = stack.shape[1]
    sweep_bytes = 4 * pixels32 + 4 * (6 + 3 + 3) * cov + 4 * 12 * pixels32
    walk = bwd.out_sweep_stats(s_rgb, fc32, fim)
    bounds['insweep'] = _bound(sweep_bytes, 0)
    # the out-sweep in accumulate mode reads the face map, xy at covered
    # pixels and rgb + grad rgb on the lines that sweep, and reads and
    # writes the 2 channels of each active crossing
    bounds['outsweep'] = _bound(
        4 * pixels32 + 4 * 6 * cov + 4 * 6 * walk['line_pixels']
        + 2 * 2 * 4 * walk['active'], SWEEP_POS_OPS * walk['positions'])
    reduced = reduce()
    cols = reduced.shape[1]
    bounds['face_reduce'] = _bound(
        4 * pixels32 + 4 * channels * cov + 4 * BATCH * nf2 * cols,
        channels * cov)
    _log(f'backward bounds at bs {BATCH}, {RASTER}^2, rgb: {cov} covered '
         f'pixels; out-sweep: {walk["active"]} active crossings sweeping '
         f'{walk["positions"]} positions x {SWEEP_POS_OPS} operations on '
         f'{walk["sweep_lines"]} lines over {walk["line_pixels"]} pixels '
         f'(out_sweep_stats, the most in one batch row and axis: '
         f'{walk["out_crossings"]}); '
         + ', '.join(f'{k} {bounds[k][0]:.4f} ms by {bounds[k][1]}'
                     for k in ('insweep', 'outsweep', 'face_reduce'))
         + '; the out-sweep\'s operations alone '
         f'{_bound(0, SWEEP_POS_OPS * walk["positions"])[0]:.4f} ms')

    # the library side of face_reduce, from the kernel's own inputs (the
    # channel-leading stack and the face map): the K6 factors expanded to
    # their cell columns, the covered pixels' rows gathered pixel-major,
    # then one index_add_ into per-face rows.  No single PyTorch call
    # computes the function; index_add_ is its library core, timed alone
    # on rows gathered beforehand as well
    naux = k6 * k6 + k6 + 3

    def library_reduce():
        covered = (fim >= 0).reshape(-1)
        seg = bwd.face_segments(fim, nf2).reshape(-1)[covered]
        full = torch.cat([stack[:, :channels - naux],
                          tex.texture_channels_cells(
                              stack[:, channels - naux:], k6)], dim=1)
        rows = full.permute(0, 2, 3, 1).reshape(-1, cols)[covered]
        sums = torch.zeros((BATCH * nf2, cols), device=dev)
        return sums.index_add_(0, seg, rows), seg, rows

    sums, seg, rows = library_reduce()
    err, _ = _sum_check('face_reduce library side', sums, reduced, 1)
    library['face_reduce'] = _time_ms(library_reduce, reps=20, warmup=2)
    add_ms = _time_ms(lambda: sums.index_add_(0, seg, rows), reps=20,
                      warmup=2)
    _log(f'library side of face_reduce from its inputs (K6 expansion, '
         f'gather of the {cov} covered pixel rows x {cols} columns, '
         f'index_add_) {library["face_reduce"]:.3f} ms, of which '
         f'index_add_ alone {add_ms:.3f} ms, on {smi}; max |diff| vs the '
         f'kernel {err:.3g}')
    del stack, maps, grads, sweep, sweep_sum, k5, rows, seg, sums
    del reduced

    # ---- 7. the main path: training steps ----
    vg = v.clone().requires_grad_()
    tg = torch.as_tensor(np.tile(tex2[None], (BATCH, 1, 1, 1, 1, 1)),
                         device=dev).requires_grad_()
    trainer = nt.Renderer()
    trainer.image_size = OUT_SIZE

    def step(eye):
        trainer.eye = eye
        vg.grad = None
        tg.grad = None
        image = trainer.render(vg, f, tg)
        image.sum().backward()
        return image

    step(eyes[0])                                 # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    for eye in eyes:
        step(eye)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _launches()
    for name in TRAINING_KERNELS:
        _require(launches[name] >= len(eyes), f'training path launched '
                 f'{name} {launches[name]} times in {len(eyes)} steps')
    for name, g in (('vertices', vg.grad), ('textures', tg.grad)):
        _require(g is not None and bool(torch.isfinite(g).all())
                 and float(g.abs().max()) > 0,
                 f'{name} gradient missing, non-finite or zero')
    _log(f'main path (training): {len(eyes)} steps x batch {BATCH}, '
         f'{OUT_SIZE}^2 AA, ts 2, forward + sum(image).backward() w.r.t. '
         f'vertices and textures: {elapsed:.4f} s, '
         f'{len(eyes) * BATCH / elapsed:.2f} training images/s on {smi}; '
         f'launches {launches}; max |grad| vertices '
         f'{float(vg.grad.abs().max()):.6g} textures '
         f'{float(tg.grad.abs().max()):.6g}')
    prof = _step_profile(step, eyes)
    segment_step_ms = None
    if prof is None:
        _log('training step profile: the profiler reported no device time '
             '(not measured)')
    else:
        dev_ms, wall_ms, by, step_ops = prof
        segment_step_ms = by['segment_sum']
        step_ms = elapsed * 1e3 / len(eyes)
        _log(f'training step profile (torch.profiler, one sweep of '
             f'{len(eyes)} steps) on {smi}: per step {_fmt_ops(step_ops)}; '
             f'device {dev_ms:.3f} ms per step '
             f'(profiled wall {wall_ms:.3f} ms); against the unprofiled '
             f'sweep\'s {step_ms:.3f} ms per step the card idles '
             f'{100 * (1 - dev_ms / step_ms):.1f}%; per step '
             + ', '.join(f'{k} {v:.3f} ms ({100 * v / dev_ms:.1f}%)'
                         for k, v in by.items()))
    # two steps of one eye: the vertex gradient (the segmented sum) and the
    # texture gradient bitwise equal
    repeat = []
    for _ in range(2):
        step(eyes[0])
        repeat.append((vg.grad.clone(), tg.grad.clone()))
    _require(_grads_equal(*repeat), 'two training steps of the main path '
             'gave different gradients')
    _log('main path: two steps of one eye give bitwise-equal vertex and '
         'texture gradients')
    del vg, tg, repeat

    # ---- 8. a trainer ----
    mesh = nt.Mesh.from_obj(os.path.join(DATA, 'teapot.obj'), texture_size=2,
                            seed=args.seed)
    _require(all(p.device == dev for p in (mesh.vertices, mesh.textures,
                                           mesh.faces)),
             'Mesh.from_obj did not build its tensors on the card')
    fit = nt.Renderer()
    fit.image_size = OUT_SIZE
    fit.eye = np.array([e for e in eyes for _ in range(BATCH // 8)],
                       np.float32)
    with torch.no_grad():
        tv, tf, tt = mesh.get_batch(BATCH)
        shift = torch.tensor([0.05, 0.03, 0.0], device=dev)
        target = fit.render(tv + shift, tf, 1.0 - tt)
    opt = nt.Adam(mesh.lr_scales(), alpha=0.01)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        bv, bf, bt = mesh.get_batch(BATCH)
        loss = ((fit.render(bv, bf, bt) - target) ** 2).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    _log(f'trainer: Mesh (teapot, ts 2) + Adam(alpha 0.01), batch {BATCH} '
         f'(8 azimuths x {BATCH // 8}), {OUT_SIZE}^2 AA, L2 to a shifted '
         f'mesh; loss {" ".join(f"{x:.2f}" for x in losses)}')
    _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
             'the loss did not fall')

    # ---- 9. gradient anchors ----
    for ci, (verts, pyi, pxi, on_face, want) in enumerate(ANCHORS):
        for mode in ('sil', 'rgb'):
            got = _anchor_grad(verts, pyi, pxi, on_face, mode, dev)
            full = np.zeros((4, 3, 3), np.float32)
            full[2] = want
            err = float(np.abs(got - full).max())
            ok = np.allclose(got, full, rtol=1e-2, atol=1e-5)
            _log(f'anchor case {ci + 1} {mode}: max abs err {err} '
                 f'(rtol 1e-2, atol 1e-5) {"ok" if ok else "FAILED"}')
            _require(ok, f'gradient anchor case {ci + 1} {mode} failed')
    ref = np.load(os.path.join(DATA, 'teapot_grad_fingerprint.npz'))
    r64 = nt.Renderer()
    r64.image_size = 64
    r64.anti_aliasing = False
    vt, ft, _ = nt.arrays_from_numpy(vz, fz, None, dev)
    vt.requires_grad_()
    (r64.render_silhouettes(vt, ft)
     * torch.as_tensor(ref['seed'], device=dev)).sum().backward()
    g = vt.grad.cpu().numpy()
    scale = float(np.abs(ref['grad']).max())
    err = float(np.abs(g - ref['grad']).max())
    _log(f'grad fingerprint: max abs err {err} = {err / scale:.3g} x max '
         f'|grad| (tolerance {FINGERPRINT_TOL} x max); zero rows max '
         f'{float(np.abs(g[[0, 1, 3]]).max())}')
    _require(err <= FINGERPRINT_TOL * scale, 'grad fingerprint differs')
    _require(np.abs(g[[0, 1, 3]]).max() == 0, 'zero rows got gradient')

    # ---- 10. index kernel vs plain ----
    iworst = 0.0
    for kind_ in ('random', 'duplicated', 'degenerate'):
        fc = rng.uniform(-0.9, 0.9, (2, 40, 3, 3)).astype(np.float32)
        fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
        if kind_ == 'duplicated':
            fc[:, 20:] = fc[:, :20]             # ties go to the lower id
        elif kind_ == 'degenerate':
            fc[:, [3, 11, 17]] = 0.0
            fc[:, [25, 31], 1] = fc[:, [25, 31], 0]
        s = RasterizeSettings(image_size=64, eps=1e-3)
        iworst = max(iworst, _compare_index(f'{kind_} 64^2 nf 40', s,
                                            torch.as_tensor(fc, device=dev)))
        _compare_bins(f'{kind_} 64^2 nf 40', s,
                      torch.as_tensor(fc, device=dev))
        if kind_ == 'duplicated':
            got = forward_cuda.forward_face_index_map(
                s, torch.as_tensor(fc, device=dev))[0]
            _require(int(got.max()) < 20, 'a duplicated face beat its '
                     'lower-id copy')
    for name, fc in ((f'teapot {RASTER}^2 bs 4', fc4),
                     (f'golden batch {RASTER}^2 bs 4', fcg),
                     (f'teapot {RASTER}^2 bs {BATCH} (main shape)', fc32)):
        iworst = max(iworst, _compare_index(name, s512, fc))

    def index_kernel():
        return forward_cuda.forward_face_index_map(s512, fc32)

    def index_plain():
        return forward_cuda.forward_face_index_map_plain(s512, fc32)

    k1 = _time_ms(index_kernel, reps=20, warmup=3)
    p1 = _time_ms(index_plain, reps=3)
    k2 = _time_ms(index_kernel, reps=20)
    p2 = _time_ms(index_plain, reps=3)
    alone['forward_index'] = _kernel_device_ms(index_kernel, 10,
                                               'index_kernel')
    times['forward_index'] = (k1, p1)
    # faces read once; index and depth written once per pixel
    bounds['forward_index'] = _bound(4 * fc32.numel() + 2 * 4 * pixels32,
                                     PAIR_OPS * pairs32)
    _log(f'time at bs {BATCH}, {RASTER}^2, nf {nf2} on {smi}: '
         f'forward_face_index_map {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / '
         f'{p2:.3f} ms (kernel, plain, kernel, plain); kernel alone '
         f'(profiler) {_fmt_ms(alone["forward_index"])}; bound '
         f'{bounds["forward_index"][0]:.4f} ms by '
         f'{bounds["forward_index"][1]} ({pairs32} binned pairs x '
         f'{PAIR_OPS} ops = {_bound(0, PAIR_OPS * pairs32)[0]:.4f} ms)')

    # ---- 11. the tune path ----
    tuner = nt.Renderer()
    tuner.image_size = OUT_SIZE
    saved_eye = tuner.eye
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    overrides = nt.tune(tuner, v, f, eyes=eyes, margin=1.0, textures=t)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    tune_launches = _launches()
    _log(f'tune: teapot batch {BATCH}, {OUT_SIZE}^2 AA, {len(eyes)} '
         f'azimuths, margin 1.0: {overrides} in {elapsed:.4f} s on {smi}; '
         f'launches {tune_launches}')
    _require(tune_launches['forward_index'] >= len(eyes),
             f'tune launched the index kernel '
             f'{tune_launches["forward_index"]} times for {len(eyes)} eyes')
    _require(tuner.eye is saved_eye and tuner.perf_overrides == overrides,
             'tune did not restore the eye or record its dict')
    s_tune = RasterizeSettings(image_size=RASTER, return_rgb=False,
                               return_alpha=True, return_depth=False)
    f_back = tuner._fill_back_faces(f.long())
    for eye in eyes:
        tuner.eye = eye
        with torch.no_grad():
            fc = nt.vertices_to_faces(tuner._transform(v), f_back)
        m = nt.measure_scene(s_tune, fc)
        covers = (m['binned_faces'] <= overrides['faces_per_tile_cap']
                  and m['csr_rows'] <= overrides['grad_csr_rows']
                  and m['out_offset'] < overrides['grad_offset_radius']
                  and m['out_crossings'] <= overrides['grad_out_cap']
                  and m['row_crossings'] <= overrides.get('grad_row_cap',
                                                          256))
        _require(covers, f'tune does not cover eye {eye}: {m}')
    tuner.eye = saved_eye
    _log(f'tune covers measure_scene of all {len(eyes)} azimuths '
         f'(last: {m})')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        declined = nt.tune(tuner, v, f, eyes=eyes, margin=1.0, textures=t,
                           measure=True)
    _require(declined == {} and tuner.perf_overrides == overrides
             and tuner.eye is saved_eye and caught,
             'tune(measure=True) did not decline with a warning')
    _log(f'tune(measure=True): {declined}, perf_overrides untouched; '
         f'warning: {caught[0].message}')

    # ---- 12. a large mesh ----
    lv, lf = _icosphere(6)
    lvt = torch.as_tensor(lv[None], device=dev)
    lft = torch.as_tensor(lf[None].astype(np.int64), device=dev)
    large = nt.Renderer()
    large.image_size = OUT_SIZE
    large.eye = eyes[1]
    with torch.no_grad():
        fcl = nt.vertices_to_faces(large._transform(lvt),
                                   large._fill_back_faces(lft))
    nfl = fcl.shape[1]
    _compare_bins(f'icosphere nf {nfl} {RASTER}^2 bs 1', s512, fcl)
    iworst = max(iworst, _compare_index(
        f'icosphere nf {nfl} {RASTER}^2 bs 1', s512, fcl))
    del fcl
    lbs = 4
    lv4 = lvt.expand(lbs, -1, -1).clone().requires_grad_()
    lf4 = lft.expand(lbs, -1, -1)

    def large_step(eye):
        large.eye = eye
        lv4.grad = None
        sil = large.render_silhouettes(lv4, lf4)
        sil.sum().backward()
        return sil

    large_step(eyes[0])                           # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    for eye in eyes:
        sil = large_step(eye)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    large_launches = _launches()
    for name in TRAINING_KERNELS:
        _require(large_launches[name] >= len(eyes),
                 f'large-mesh step launched {name} '
                 f'{large_launches[name]} times in {len(eyes)} steps')
    g = lv4.grad
    _require(g is not None and bool(torch.isfinite(g).all())
             and float(g.abs().max()) > 0,
             'large-mesh vertex gradient missing, non-finite or zero')
    _require(float(sil.detach().amax()) == 1.0,
             'an empty icosphere silhouette')
    _log(f'large mesh (training): icosphere nf {nfl}, {len(eyes)} steps x '
         f'batch {lbs}, {OUT_SIZE}^2 AA, render_silhouettes + '
         f'sum().backward() w.r.t. vertices: {elapsed:.4f} s, '
         f'{len(eyes) * lbs / elapsed:.2f} training images/s on {smi}; '
         f'launches {large_launches}; max |grad| {float(g.abs().max()):.6g}')

    # ---- 13. long lines: the out-sweep at any line length ----
    lv_s, lf_s = _sparse_scene(rng, 400)
    tex_s = rng.uniform(0, 1, (lf_s.shape[0], 2, 2, 2, 3)).astype(np.float32)
    vs_t = torch.as_tensor(lv_s[None], device=dev)
    fs_t = torch.as_tensor(lf_s[None].astype(np.int64), device=dev)
    ts_t = torch.as_tensor(tex_s[None], device=dev)
    long_raster = 2 * LONG_OUT
    long_times = {}
    for mode in ('silhouettes', 'rgb'):
        rgb_mode = mode == 'rgb'
        s_long = RasterizeSettings(image_size=long_raster, eps=1e-3,
                                   return_rgb=rgb_mode,
                                   return_alpha=not rgb_mode,
                                   return_depth=False)
        fc_l, tx_l = _raster_inputs(lv_s, lf_s, tex_s, [eyes[1]],
                                    long_raster, dev)
        maps, grads = _bwd_scene(s_long, fc_l, tx_l if rgb_mode else None,
                                 rng, dev)
        args_l = _sweep_args(s_long, maps, grads)
        plan = backward_cuda.outsweep_plan(
            long_raster, rgb_mode, not rgb_mode,
            backward_cuda._smem_limit(0))
        t0 = time.perf_counter()
        want = backward_cuda.outsweep_plain(*args_l)
        want_in = backward_cuda.insweep_plain(*args_l)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        got, again = backward_cuda.outsweep(*args_l), backward_cuda.outsweep(
            *args_l)
        acc, acc2 = _accumulated(args_l), _accumulated(args_l)
        torch.cuda.synchronize()
        _require(bool(torch.equal(got, again)) and bool(torch.equal(acc, acc2)),
                 f'long lines {mode}: an out-sweep repeat run differs')
        err, ratio = _sum_check(f'long lines {mode} outsweep', got, want, 1)
        err2, ratio2 = _sum_check(f'long lines {mode} outsweep accumulate',
                                  acc, want_in + want, 1)
        bworst['outsweep'] = max(bworst['outsweep'], err, err2)
        long_times[mode] = _time_ms(lambda: backward_cuda.outsweep(*args_l),
                                    reps=5)
        _log(f'long lines, {mode} at bs 1, {long_raster}^2 ({lf_s.shape[0]} '
             f'sparse faces, fill_back): out-sweep plan {plan}; write mode '
             f'max abs err {err} ({ratio:.3g} x channel max), accumulated on '
             f'the in-sweep {err2} ({ratio2:.3g} x); repeat runs bitwise '
             f'equal; {long_times[mode]:.3f} ms (write mode) on {smi}; the '
             f'plain sweeps took {plain_s:.1f} s')
        del maps, grads, args_l, want, want_in, got, again, acc, acc2

        # the training step through the Renderer, twice
        r_long = nt.Renderer()
        r_long.image_size = LONG_OUT
        r_long.eye = eyes[1]
        if rgb_mode:
            def fn(vv, tt):
                return r_long.render(vv, fs_t, tt)
            leaves = (vs_t, ts_t)
        else:
            def fn(vv):
                return r_long.render_silhouettes(vv, fs_t)
            leaves = (vs_t,)
        _reset_launches()
        g1 = _grad_step(fn, leaves)
        torch.cuda.synchronize()
        long_launches = _launches()
        g2 = _grad_step(fn, leaves)
        _require(long_launches['outsweep'] >= 1 and _grads_ok(g1)
                 and _grads_equal(g1, g2),
                 f'long lines {mode} step: launches {long_launches}, or '
                 'gradients missing, non-finite, zero or not repeatable')
        _log(f'long lines, {mode} training step at {LONG_OUT}^2 AA '
             f'({long_raster}^2 raster), bs 1: launches {long_launches}; '
             'gradients finite, non-zero, bitwise equal on a repeat step')
        del g1, g2

    # a 2800 raster (render at 1400^2 AA) and an 8192 raster (render_rgbad
    # at 4096^2 AA): training steps through the kernel
    for out_size, method in ((1400, 'render'), (4096, 'render_rgbad')):
        r_long = nt.Renderer()
        r_long.image_size = out_size
        r_long.eye = eyes[1]
        call = getattr(r_long, method)

        def fn(vv, tt):
            return call(vv, fs_t, tt)

        _reset_launches()
        t0 = time.perf_counter()
        g1 = _grad_step(fn, (vs_t, ts_t))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        long_launches = _launches()
        g2 = _grad_step(fn, (vs_t, ts_t))
        _require(long_launches['outsweep'] >= 1 and _grads_ok(g1)
                 and _grads_equal(g1, g2),
                 f'{method} at a {2 * out_size} raster: launches '
                 f'{long_launches}, or gradients missing, non-finite, zero or '
                 'not repeatable')
        _log(f'long lines, {method} training step at {out_size}^2 AA '
             f'({2 * out_size}^2 raster), bs 1: {step_s:.3f} s, launches '
             f'{long_launches}; gradients finite, non-zero, bitwise equal '
             'on a repeat step')
        del g1, g2
    torch.cuda.empty_cache()

    # rounds forced at 512^2: a small crossing list, staged planes and
    # planes read from device memory, against the plain version
    maps, grads = _bwd_scene(s_all, fc4, tx4, rng, dev)
    args4 = _sweep_args(s_all, maps, grads)
    want = backward_cuda.outsweep_plain(*args4)
    want_acc = backward_cuda.insweep_plain(*args4) + want
    forced = []
    for cap in FORCED_CAPS:
        for staged in (True, False):
            got = backward_cuda._outsweep(*args4, None, False, cap, staged)
            again = backward_cuda._outsweep(*args4, None, False, cap, staged)
            acc = backward_cuda.insweep(*args4)
            backward_cuda._outsweep(*args4, acc, True, cap, staged)
            torch.cuda.synchronize()
            _require(bool(torch.equal(got, again)),
                     f'forced rounds cap {cap}: repeat run differs')
            err, ratio = _sum_check(f'forced rounds cap {cap}', got, want, 1)
            err2, ratio2 = _sum_check(f'forced rounds cap {cap} accumulate',
                                      acc, want_acc, 1)
            bworst['outsweep'] = max(bworst['outsweep'], err, err2)
            forced.append(f'cap {cap} staged {staged}: {ratio:.3g} / '
                          f'{ratio2:.3g} x')
    _log(f'forced rounds, teapot {RASTER}^2 bs 4 rgb + alpha (lines of up '
         f'to {3 * RASTER} crossings): {"; ".join(forced)} channel max '
         '(write / accumulated); repeat runs bitwise equal')
    del maps, grads, args4, want, want_acc, got, again, acc

    # ---- 14. deterministic scatters: the segmented sum ----
    r8 = nt.Renderer()
    r8.image_size = OUT_SIZE
    r8.eye = np.array(eyes[::2], np.float32)
    t8 = torch.as_tensor(rng.uniform(0, 1, (4, faces.shape[0], 8, 8, 8, 3))
                         .astype(np.float32), device=dev)

    def step8(vv, tt):
        return r8.render(vv, f[:4], tt)

    _reset_launches()
    g1 = _grad_step(step8, (v[:4], t8))
    torch.cuda.synchronize()
    launches8 = _launches()
    g2 = _grad_step(step8, (v[:4], t8))
    _require(_grads_ok(g1) and _grads_equal(g1, g2),
             'the ts 8 step\'s gradients are not finite, non-zero and '
             'bitwise repeatable')
    _require(launches8['segment_sum'] >= 2, 'the ts 8 step did not sum its '
             f'vertex and texture gradients by segments: {launches8}')
    ts8_ms = _time_ms(lambda: _grad_step(step8, (v[:4], t8)), reps=3)
    _log(f'ts 8 training step, bs 4, {OUT_SIZE}^2 AA: vertex and texture '
         f'gradients bitwise equal on a repeat step; {ts8_ms:.3f} ms a step '
         f'on {smi}; launches {launches8}')
    del g1, g2, t8

    # the ts 8 texture gradient as the backward computes it on the card (its
    # rows sorted by cell, then the segmented sum) against its plain version
    # (index_add_ of the rows in order) on CPU copies of the same maps, then
    # the sort of its rows timed at bs 4 and at the main shape (the bs 4
    # maps repeated to batch 32)
    s8 = RasterizeSettings(image_size=RASTER, eps=1e-3, return_alpha=False,
                           return_depth=False)
    tex8 = rng.uniform(0, 1, (faces.shape[0], 8, 8, 8, 3)).astype(np.float32)
    fc8, tx8 = _raster_inputs(vertices, faces, tex8, eyes[::2], RASTER, dev)
    maps8, grads8 = _bwd_scene(s8, fc8, tx8, rng, dev)
    tex_maps = (maps8['face_index_map'], maps8['z'].permute(0, 2, 3, 1),
                maps8['weights'].permute(0, 2, 3, 1), maps8['depth_map'],
                grads8['g_rgb'])
    shape8 = tuple(tx8.shape)
    del fc8, tx8, maps8, grads8
    got = tex.grad_textures(s8, *tex_maps, shape8)
    again = tex.grad_textures(s8, *tex_maps, shape8)
    want = tex.grad_textures(s8, *(x.cpu() for x in tex_maps), shape8)
    torch.cuda.synchronize()
    _require(bool(torch.equal(got, again)),
             'ts 8 texture gradient: a repeat run differs')
    got, want = got.cpu().reshape(-1, 3), want.reshape(-1, 3)
    scale = want.abs().amax(0, keepdim=True)
    err = (got - want).abs()
    _require(float(scale.min()) > 0 and bool((err <= SEGMENT_TOL * scale).all()),
             'ts 8 texture gradient: differs from the plain version by '
             f'{float(err.max())} (column max {scale.tolist()})')
    tex_err = float(err.max())
    sort_ms = {}
    for bs_t in (4, BATCH):
        maps_t = [x.repeat((bs_t // 4,) + (1,) * (x.ndim - 1))
                  for x in tex_maps]
        shape_t = (bs_t,) + shape8[1:]
        nseg_t = int(np.prod(shape_t[:-1]))
        ids_t, rows_t = tex.corner_rows(s8, *maps_t, shape_t, nseg_t)
        perm_t, offsets_t = segments.sort_segments(ids_t, nseg_t)
        sort_ms[bs_t] = dict(
            rows=ids_t.shape[0], covered=int(offsets_t[-1]),
            sort_ms=_time_ms(lambda: segments.sort_segments(ids_t, nseg_t),
                             reps=3),
            sum_ms=_time_ms(lambda: segments.segment_sum(rows_t, perm_t,
                                                         offsets_t), reps=3),
            grad_ms=_time_ms(lambda: tex.grad_textures(s8, *maps_t, shape_t),
                             reps=3))
        del maps_t, ids_t, rows_t, perm_t, offsets_t
        torch.cuda.empty_cache()
    _log(f'ts 8 texture gradient, bs 4, {RASTER}^2: the card against the '
         f'plain version on the CPU, max abs err {tex_err:.3g} '
         f'({SEGMENT_TOL} x column max), repeat runs bitwise equal; '
         + '; '.join(
             f'bs {b}: {t["rows"]} rows ({t["covered"]} covered), '
             f'sort_segments {t["sort_ms"]:.3f} ms, segment_sum '
             f'{t["sum_ms"]:.3f} ms, grad_textures {t["grad_ms"]:.3f} ms'
             for b, t in sort_ms.items()) + f' on {smi}')
    del tex_maps, got, again, want, err

    # the kernel against its plain version at the main path's vertex
    # scatter (bs 32 x 4928 faces x 3 slots onto bs 32 x 1292 vertices) and
    # at the ts 8 texture scatter's scale (8 corners of bs 4 x 512^2 pixels
    # onto bs 4 x 4928 x 8^3 cells)
    f_back = trainer._fill_back_faces(f.long())
    nv = vertices.shape[0]
    flat = (f_back + (torch.arange(BATCH, device=dev) * nv)[:, None, None]
            ).reshape(-1)
    seg_cases = [('vertices', flat, BATCH * nv)]
    n8, nseg8 = 8 * 4 * RASTER * RASTER, 4 * nf2 * 8 ** 3
    seg_cases.append(('ts 8 textures', torch.as_tensor(
        rng.randint(0, nseg8 + nseg8 // 3, n8), device=dev), nseg8))
    seg_worst = tex_err
    for name, ids, nseg in seg_cases:
        rows = torch.as_tensor(rng.normal(0, 1, (ids.shape[0], 3)).astype(
            np.float32), device=dev)
        perm, offsets = segments.sort_segments(ids, nseg)
        got = segments.segment_sum(rows, perm, offsets)
        again = segments.segment_sum(rows, perm, offsets)
        want = segments.segment_sum_plain(rows, perm, offsets)
        torch.cuda.synchronize()
        _require(bool(torch.equal(got, again)),
                 f'segment_sum {name}: repeat run differs')
        scale = want.abs().amax(0, keepdim=True)
        err = (got - want).abs()
        _require(bool((err <= SEGMENT_TOL * scale).all()),
                 f'segment_sum {name}: differs from the plain version by '
                 f'{float(err.max())}')
        seg_worst = max(seg_worst, float(err.max()))

        def kern():
            return segments.segment_sum(rows, perm, offsets)

        def plain_fn():
            return segments.segment_sum_plain(rows, perm, offsets)

        def library_fn():
            return torch.zeros((nseg + nseg // 3 + 1, 3), device=dev
                               ).index_add_(0, ids, rows)

        seg = dict(ms=_time_ms(kern, reps=20, warmup=2),
                   plain_ms=_time_ms(plain_fn, reps=5),
                   alone_ms=_kernel_device_ms(kern, 5, 'segment_sum_kernel'),
                   library_ms=_time_ms(library_fn, reps=20, warmup=2))
        used = int(offsets[-1])
        # rows read once through their permutation, offsets, sums written
        seg['bound_ms'], seg['bound_by'] = _bound(
            (4 * 3 + 8) * used + 8 * (nseg + 1) + 4 * 3 * nseg, 3 * used)
        _log(f'segment_sum {name}: {used} rows onto {nseg} segments, max abs '
             f'err {float(err.max()):.3g} ({SEGMENT_TOL} x column max), '
             f'repeat runs bitwise equal; kernel {seg["ms"]:.3f} ms, alone '
             f'{_fmt_ms(seg["alone_ms"])}, plain {seg["plain_ms"]:.3f} ms, '
             f'index_add_ {seg["library_ms"]:.3f} ms, bound '
             f'{seg["bound_ms"]:.4f} ms by {seg["bound_by"]} on {smi}')
        if name == 'vertices':
            seg_main = seg
        del rows, perm, offsets, got, again, want, err
    del seg_cases, flat

    # ---- 15. parallel on one card: 2 ranks over gloo ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _spawn_ranks(RANKS, args.seed)
    par_s = time.perf_counter() - t0
    for res in ranks:
        for ts in (2, 8):
            c = res[f'ts{ts}']
            _require(c['images_equal'] and c['raster_images_equal']
                     and c['finite'],
                     f'rank {res["rank"]} ts {ts}: the face-sharded render '
                     'differs from the one-process render')
            _require(c['textures_equal'] and c['raster_textures_equal']
                     and c['texture_grad_max'] > 0,
                     f'rank {res["rank"]} ts {ts}: texture gradients differ')
            _require(c['faces_ok'] and c['vertices_ok'],
                     f'rank {res["rank"]} ts {ts}: face or vertex gradients '
                     f'break the contract: {c}')
            _require(all(c['launches'][k] >= 1 for k in TRAINING_KERNELS),
                     f'rank {res["rank"]} ts {ts}: launches {c["launches"]}')
        dp = res['dp']
        _require(dp['losses'][2] < dp['losses'][0],
                 f'rank {res["rank"]}: the data-parallel loss did not fall: '
                 f'{dp["losses"]}')
    _require(len({res['dp']['checksum'] for res in ranks}) == 1,
             'the data-parallel ranks hold different parameters')
    for res in ranks:
        _log(f'parallel rank {res["rank"]} of {RANKS} (gloo, one card): '
             + '; '.join(
                 f'face-sharded render_rgbad ts {ts} bit-equal, textures '
                 f'equal, faces {c["faces_differ"]:.4f} of elements differ '
                 f'(max {c["faces_err"]:.3g} x max |grad|), vertices '
                 f'{c["vertices_differ"]:.4f} (max {c["vertices_err"]:.3g} '
                 f'x), launches {c["launches"]}'
                 for ts, c in ((2, res['ts2']), (8, res['ts8'])))
             + f'; data parallel, {res["dp"]["rows"]} rows a rank: loss '
             + ' '.join(f'{x:.2f}' for x in res['dp']['losses']))
    _log(f'parallel phase: {RANKS} spawned ranks, {par_s:.1f} s')

    # ---- 16. spatial face order: one timed forward sweep each ----
    sweep_ms = {}
    for ordered in (False, True):
        m = nt.Mesh.from_obj(os.path.join(DATA, 'teapot.obj'),
                             texture_size=2, seed=args.seed,
                             spatial_order=ordered)
        with torch.no_grad():
            mv, mf, mt = m.get_batch(BATCH)
            renderer.render(mv, mf, mt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for eye in eyes:
                renderer.eye = eye
                renderer.render(mv, mf, mt)
            torch.cuda.synchronize()
        sweep_ms[ordered] = (time.perf_counter() - t0) * 1e3 / len(eyes)
    _log(f'spatial order: forward sweep of {len(eyes)} renders, batch '
         f'{BATCH}, {OUT_SIZE}^2 AA: {sweep_ms[False]:.3f} ms a render in '
         f'file order, {sweep_ms[True]:.3f} ms with Mesh(spatial_order=True) '
         f'on {smi} (one sweep each, no claim)')

    sources = {
        'forward_shaded': ('neural_renderer_torch/csrc/forward_shaded.cu',
                           'neural_renderer_tpu/rasterize/'
                           'forward_pallas.py:636', worst, launches),
        'forward_index': ('neural_renderer_torch/csrc/forward_index.cu',
                          'neural_renderer_tpu/rasterize/'
                          'forward_pallas.py:353', iworst, tune_launches),
        'insweep': ('neural_renderer_torch/csrc/backward_sweeps.cu',
                    'neural_renderer_tpu/rasterize/backward_pallas.py:68',
                    bworst['insweep'], launches),
        'outsweep': ('neural_renderer_torch/csrc/backward_sweeps.cu',
                     'neural_renderer_tpu/rasterize/backward_pallas.py:276',
                     bworst['outsweep'], launches),
        'face_reduce': ('neural_renderer_torch/csrc/face_reduce.cu',
                        'neural_renderer_tpu/rasterize/backward_pallas.py:867',
                        bworst['face_reduce'], launches),
    }
    _log(json.dumps({'segment_sum': {
        'name': 'segment_sum', 'route': 'cuda',
        'source': 'neural_renderer_torch/csrc/segment_sum.cu',
        'replaces': 'XLA code, not a TPU kernel: neural_renderer_tpu/ops/'
                    'vertices_to_faces.py:57-93 and neural_renderer_tpu/'
                    'rasterize/texture.py:258-285',
        'launches': launches['segment_sum'],
        'launches_per_step': launches['segment_sum'] / len(eyes),
        'max_abs_err': seg_worst, 'step_profile_ms': segment_step_ms,
        'ts8_texture_scatter': sort_ms, **seg_main}}))
    _log(json.dumps({'binning': {
        'name': 'bin_faces', 'route': 'cuda',
        'source': 'neural_renderer_torch/csrc/bin_faces.cu',
        'replaces': 'XLA code, not a TPU kernel: neural_renderer_tpu/'
                    'rasterize/forward_pallas.py:211-299 (_face_tile_ranges, '
                    '_membership_prefix, _feature_table)',
        'launches': launches['bin_faces'], 'max_abs_err': 0.0,
        **binning_times}}))
    _log(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
        'launches': counts[name], 'max_abs_err': err_k,
        'ms': times[name][0], 'plain_ms': times[name][1],
        'bound_ms': bounds[name][0], 'bound_by': bounds[name][1],
        'library_ms': library.get(name), 'kernel_alone_ms': alone[name],
        **extra.get(name, {}),
    } for name, (src, rep, err_k, counts) in sources.items()]}))
    _log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
