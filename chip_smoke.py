"""Smoke run of the PyTorch port (neural_renderer_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; progress goes to stdout):
  1. the card: ``torch.cuda.is_available()``, name and power limit;
  2. build the CUDA kernels from ``neural_renderer_torch/csrc`` (eight
     sources: the five TPU kernels' counterparts, the forward's setup and
     binning, the segmented sum, the output pass and the texture scatter;
     one nvcc each, all started together)
     and print ptxas' register and shared-memory report;
  3. the forward kernel against its plain PyTorch version on the card,
     inputs from ``--seed``: random 64^2 scenes (no textures, ts 2/3/4) and
     the teapot at a 512^2 raster (bs 4 ts 2, the golden batch at ts 4, and
     the main path's bs 32 ts 2); face_index_map must match exactly, the
     other maps within the stated tolerances; both timed at the main path's
     shape.  On every scene the device setup and binning
     (``forward_cuda.bin_setup``) against ``_face_records``,
     ``_index_records`` and ``bin_faces``: records bit-equal, ``start``,
     ``ids``, ``order`` and ``first`` equal, repeat runs bitwise equal
     (also at nf 1, 31, 129 and 300, the edges of its 128-face chunks,
     with a NaN face);
     at the main path's shape and on the real model's 24 views (as phase 19
     renders them: a face over 252 tiles, lists of up to 944 faces) lists
     equal and timed against the plain version in turns, with the device
     time of each of its operations, its device operations per call and
     the wait of its one host sync (the call less its device time);
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
     bs 1 on 512^2 (0 mismatches), then the benchmark's dense-mesh cell
     (``LARGE_CELL``) at its own shape, through its ``harness.Program``: a
     ``render_silhouettes`` training step at batch 128, 256^2 AA, for each
     of the 8 azimuths: every hand-written training kernel launches once a
     step and no other, the vertex gradient is finite and non-zero, the
     binning's ``work.faces`` and ``work.bin_cells`` equal the shape's faces
     and (tile, chunk) cells, ``work.bin_pairs`` equals the port's padded
     tile boxes (at least the pairs ``binning_roofline.sil`` counts on the
     reference's faces); images/s, peak memory and host waits printed;
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
     (``texture.grad_textures``: the texture scatter, ``csrc/
     tex_scatter.cu``) against its plain version on CPU copies of the same
     maps (1e-6 x column max), every cell written, repeat runs bitwise
     equal, timed against the plain version on the card; the segmented sum
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
     ``Mesh(spatial_order=True)`` and one without (no claim);
 17. the examples at their own size: ``run`` of
     ``examples/torch_example{1,2,3,4}.py`` with their defaults on the card,
     outputs in a temporary directory.  Step-0 losses at their anchors
     (rtol 1e-5: examples 2 and 4 the JAX package's, example 3 sum(ref^2));
     example 2 below 101 after 300 steps, example 4 below 70 within 1000,
     example 3 within 60,000-70,000 from step 50; example 1's 90 frames
     finite and showing the teapot; every GIF whole; in every training
     step the forward kernel, both sweeps, the reduction, the binning and
     the segmented sum launch.  10 steps of each training example under
     torch.profiler: device ms, device operations and idle share per step
     (against the run's own steps).  Then each training example's step-0
     gradient (example 2 the vertices', 3 the textures', 4 the eye's) on
     the card against the plain versions on the CPU (1e-3 x max |grad|);
 18. ``misc/torch_grad_quality.py`` on the card: its 8 rows (max |grad|,
     d loss / d v0.x) within rtol 1e-3 of the JAX package's, the "darker"
     gradient at pixel 12 exactly 0;
 19. the dataset renderer and the real ShapeNet model
     (``tests/data/4e49873292196f02574b5684eaec43e9``, every covered pixel
     a depth tie between coincident faces): ``misc/torch_render.py`` at its
     defaults over tests/data (24 views of each of its 3 meshes, 72 PNGs,
     each read back), its launches counted, wall seconds and images/s, one
     call (the model's 24 views) timed and profiled: device ms, idle share,
     device operations.  The model's forward maps at 512^2 over 24 views:
     batched views bit-equal to single ones, the kernel against the plain
     version on the card (face_index_map equal, phase 3's tolerances) and
     on CPU copies of two views.  A training step on 32 views (256^2 AA,
     ts 2): the three backward kernels against their plain versions with
     phase 6's bands (random and ``sum(image)`` output gradients), every
     training kernel launched, two steps bitwise equal.  ``tune`` on the
     model over the 8 bench azimuths, and the index kernel against its
     plain version on the 24 views;
 20. the reference timing protocol: ``misc/torch_measure_time.py`` at its
     defaults (the teapot at batch 1, 256^2 AA, ts 2, 24 azimuths, the
     first sample dropped), its four means in ms, its launches; one
     silhouette and one textured forward + backward call profiled over the
     24 azimuths (device ms, idle share, device operations, launches per
     call); at azimuths 0 and 45 the card's images (phase 3's tolerances)
     and gradients (1e-4 x max |grad|, phase 6's band) against the same
     functions on the CPU; the three backward kernels against their plain
     versions on the protocol's scenes at azimuth 45 (bs 1, 512^2,
     silhouettes and textured, ``sum(image)`` and random output
     gradients; phase 6's rules) and the segmented sum on its vertex
     scatter (phase 14's);
 21. BASELINE config 5: ``misc/torch_multiview.py`` at its defaults (64
     views of the teapot at 512^2 AA through ``render_rgbad``, ``tune``
     over 8 eyes, one warm-up and 4 timed calls over a one-rank gloo
     group): ms per batch, images/s, the peak of ``max_memory_allocated``,
     the index kernel launched 8 times by ``tune``; one call profiled
     (device ms, idle share, device operations, its largest operations,
     its own memory peak); the script's output bit-equal to
     ``render_rgbad`` in one call and in 8 calls of 8 views; the forward
     maps of all 64 views (a 1024^2 raster) against the plain version
     (phase 3's rule), both timed; the index kernel against its plain
     version on each of the 8 scenes ``tune`` gives it (bs 64, 1024^2,
     phase 11's rule), timed; the binning at this size against its plain
     version, timed, with its (tile, chunk) cells and the sync's wait;
 22. the output pass's kernel (``csrc/composite_pool.cu``) against its
     plain version, bit for bit: adversarial maps in every layout it takes,
     pooled and not, each output alone and all three, a [3] and a [bs, 3]
     background, at shapes on and off its 16-byte path; BASELINE config
     5's real maps (1024^2 pooled, 512^2 not) and the main path's (bs 32,
     512^2, rgb only); timed alone with CUDA events around bare launches,
     as a call and against the plain version, with its byte bound; one
     config-5 call launches it once (phase 7: a training step never);
 23. the face gradient's assembly (``backward_cuda.face_grad``, in
     ``csrc/face_reduce.cu``) against its plain version, bit for bit as
     int32 patterns, on per-face random sums with -0, NaN and infinities:
     the icosphere cell's step (bs 128 x 163,840 faces, K5), the teapot
     cell's (bs 128, K5 and the K6 cells), ``render_rgbad``'s and
     ``render_depth``'s K7 layouts and an odd face count with rows further
     apart than the columns read; timed alone (CUDA events around bare
     launches), as a call, against the plain version and the chain the port
     ran before it, with its byte bound; a training step launches it once,
     a render under no_grad never (phase 22: a config-5 call never);
 24. host values kept on the card (``config.place``), in each benchmark
     cell at its own shape through ``benchmark.harness.Program``: a warmed
     call copies no host value and finds 7 kept (4 in the silhouette
     cell), and reads the pair total once; its images and gradients are
     bit-equal to the same call with nothing kept; a render after the
     ``Renderer``'s light direction, a light colour (written in place),
     background and angle change is bit-equal to a fresh ``Renderer``'s
     with nothing kept, and differs from the render before the change;
     calls timed with and without keeping, in turns (no claim);
 25. the K6 texture factors built inside the reduction's tile pass, in the
     benchmark's two teapot cells (bs 128, 512^2 raster, ts 2 and ts 4)
     through ``harness.Program``: a training step reduces once with the
     factors from the maps (``k6.in_reduce`` 1), builds none in plain
     torch, and repeats its gradients bit for bit; on the step's scene the
     reduction against ``face_reduce_plain`` on the card (``SUM_TOL``),
     repeat runs bit-equal; timed with and without the factors beside its
     bound; a step's device time by innermost span (``_span_split``);
 26. the path of cubes above ts 4 in the benchmark's ts-16 cell (bs 32,
     512^2 raster, ts 16) through ``harness.Program``: a training step
     folds the light into sampling and the scatter (``light.folded`` 1),
     launches the texture scatter (``csrc/tex_scatter.cu``) once and
     repeats its gradients bit for bit; on two elements the image
     bit-equal to the lit-cube route's, and the kernel with the light
     against ``texture.grad_textures_plain`` on CPU copies (``SEGMENT_TOL``,
     the light's gradient ``LIGHT_TOL``, and ``LIGHT_ROUTE_TOL`` against
     the lit-cube route's by autograd), carried back through fill_back;
     the kernel with lit cubes and with a light on all 32 at ts 16 and
     ts 8 and on one at ts 32 (a cube larger than shared memory): repeat
     runs bitwise equal, a launch into NaN-filled memory leaves no NaN,
     faces without a pixel all zeros; timed alone against its bound, with
     and without a light, the plain version and the sort route it
     replaced; the step's peak memory and device time by span and by
     operation;
 27. what the port's tracing costs: a span's host time under a profiler,
     as ``record_function`` and as the profiler's fast record, and with
     no profiler; in each benchmark cell the ms a call untraced and in the
     harness's two traced stretches, the device-only stretch's idle share
     and the host stretch's device time by innermost span.

Every profiler window is padded with idle host time at both ends
(``_profile``); a window that caught none of a kernel's launches is logged
and profiled again (``_kernel_device_ms``).

The last stdout line is the JSON device record.  The line before it lists
ten kernels: the five TPU kernels' counterparts, the setup and binning
(``bin_faces``), the segmented sum (``segment_sum``), the output pass
(``composite_pool``), the face gradient's assembly (``face_grad``) and the
texture scatter (``tex_scatter``), the last five not TPU kernels (the JAX
package does them in XLA).  Each has its launches on its
path (phase 7 for the training kernels, phase 11 for the index kernel) and
per step, on each example's run (phase 17), on phase 19's runs (the
dataset renderer, the model's training step and its ``tune``) and on the
runs of phases 20 and 21 (the timing protocol and config 5), its worst
error against the plain version (over every phase that compares it),
its time and the plain version's, its bound (the larger of the bytes it
must move over the card's memory rate and its operations over the f32 rate,
from this run's inputs) and the library call's time where PyTorch has one:
for the per-face reduction, its K6 expansion, the covered rows' gather and
one ``index_add_`` from the kernel's own inputs; for the segmented sum and
the texture scatter one ``index_add_`` of the rows.  The out-sweep's and
the reduction's entries also carry the other timings of phase 6, the
binning's those of phase 3 (per device operation, the sync's wait, the
model's 24 views), the segmented sum's its device time per step from phase
7's profile and phase 14's numbers at the ts 8 texture scale, the texture
scatter's phase 14's ts 8 numbers and phase 26's ts-16 step; the segmented
sum's time alone is phase 14's, at the main path's vertex scatter, the
texture scatter's phase 26's, at the ts-16 cell's shape.
"""

import argparse
import contextlib
import copy
import glob
import importlib.util
import io
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
from neural_renderer_torch import _build, parallel, tracing
from neural_renderer_torch.io.image import imread
from neural_renderer_torch.ops.lighting import light_cubes
from neural_renderer_torch.ops.vertices_to_faces import vertices_to_faces
from neural_renderer_torch.ops import segments
from neural_renderer_torch.rasterize import backward as bwd
from neural_renderer_torch.rasterize import backward_cuda, core
from neural_renderer_torch.rasterize import composite_pool
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize import texture as tex
from neural_renderer_torch.rasterize.config import RasterizeSettings

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, 'tests', 'data')
# the real ShapeNet model (every covered pixel a depth tie)
MODEL = os.path.join(DATA, '4e49873292196f02574b5684eaec43e9', 'model.obj')
BATCH = 32
OUT_SIZE = 256                 # the main path's output; its raster is 2x
RASTER = 2 * OUT_SIZE
AZIMUTHS = [float(a) for a in range(0, 360, 45)]
DISTANCE, ELEVATION = 2.732, 30.0
# the benchmark's dense-mesh cell, which phase 12 runs at its own shape
LARGE_CELL = 'icosphere163k.sil_train_b128'
# the kernels a training step launches (the index kernel serves tune)
TRAINING_KERNELS = ('forward_shaded', 'insweep', 'outsweep', 'face_reduce',
                    'face_grad', 'bin_faces', 'segment_sum')
# every hand-written kernel, as tracing.COUNTS counts its launches
LAUNCHED = ('forward_shaded', 'forward_index', 'bin_faces', 'insweep',
            'outsweep', 'face_reduce', 'face_grad', 'segment_sum',
            'composite_pool', 'tex_scatter')
# the setup and binning's device operations, by the substrings of their
# profiler names: its count and fill kernels and CUB's scan (two kernels)
BINNING_OPS = ('bin_count_kernel', 'bin_fill_kernel', 'DeviceScan')

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
# the texture scatter's light gradient against its plain version: each
# face's pixels summed in the kernel's order, held to 1e-6 x its max
LIGHT_TOL = 1e-6
# the card's light gradient against the lit-cube route's (autograd of the
# lit cube back from the plain scatter without a light): the same terms,
# summed over a face's pixels against over its texels, held to 1e-5 x
# its max (the CPU reads up to 8.8e-7 at the ts-16 cell's 512^2 raster)
LIGHT_ROUTE_TOL = 1e-5
# idle host time at each end of a profiler window (``_profile``), and the
# windows ``_kernel_device_ms`` tries before it reports "not measured"
PROFILE_PAD_S = 0.05
PROFILE_TRIES = 5
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

EXAMPLES = os.path.join(ROOT, 'examples')
EXAMPLE_DATA = os.path.join(EXAMPLES, 'data')
# the examples' step-0 losses at their own size: examples 2 and 4 from the
# JAX package on the CPU (jitted and eager alike); example 3 renders black
# at step 0, so its loss is sum(ref^2), computed from the image
STEP0_LOSS = {2: 10103.125, 4: 8444.875}
STEP0_RTOL = 1e-5
# convergence: example 2 below 1% of its step-0 loss after its 300 steps
# (the JAX package's record: 1.94), example 4 below its stop loss within
# 1000 steps (JAX: step 187), example 3 within its azimuth-dependent floor
# band (JAX: 63,106-68,737) from step 50 on.  Not from step 20: with
# seeds 0-5 every run met an azimuth whose side was not fitted yet at one
# step in 20-27, 1,594-2,918 above that azimuth's floor and past 70,000,
# and from step 50 on all six stayed within 62,786-69,075
EX2_LAST_BELOW = 101.0
EX3_FROM_STEP, EX3_BAND = 50, (60000.0, 70000.0)
# misc/grad_quality.py's rows, the JAX package on the CPU, jitted as the
# script runs it: pixel -> (max |grad|, d loss / d v0.x)
GRAD_QUALITY = {
    21: (18.205432891845703, 17.28289031982422),
    18: (4.2074875831604, 3.993992805480957),
    12: (1.657942295074463, 1.5737953186035156),
    4: (0.9170343279838562, 0.8704881072044373),
    23: (14.872220993041992, -14.14770221710205),
    28: (2.652583360671997, -2.5540060997009277),
    36: (2.233678102493286, -1.1050750017166138),
    44: (5.235466480255127, -0.7050743103027344),
}
GRAD_QUALITY_RTOL = 1e-3


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _log(*args):
    print(*args, flush=True)


def _teapot():
    vertices, faces = nt.load_obj(os.path.join(DATA, 'teapot.obj'))
    return vertices, faces


def _reset_launches():
    tracing.reset()


def _launches():
    """Launches of each hand-written kernel since ``_reset_launches``."""
    counts = tracing.counts()
    return {k: counts.get('launch.' + k, 0) for k in LAUNCHED}


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
    tile = _build.library('forward_shaded').nr_forward_shaded_tile()
    _require(_build.library('forward_index').nr_forward_index_tile() == tile,
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


@contextlib.contextmanager
def _profile():
    """torch.profiler over the host and the card, its window padded with
    ``PROFILE_PAD_S`` of idle host time at each end (the card synchronized
    before the first pad and the second).  The card's timestamps stray from
    the host's by milliseconds, and the profiler drops the device events
    that fall outside its window: ``misc/torch_profile_window.py`` (commit
    ed5d907; removed since) on an H100 stamped kernels from 4.5 ms before
    to 1.5 ms after their launch, and of 280 windows of 5 short kernels, 10
    unpadded ones lost launches and no padded one."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def _kernel_device_ms(fn, reps, kernel_name):
    """Device time per call of the CUDA kernels whose name contains
    ``kernel_name`` (a substring, or a tuple of them; summed over the
    kernels one call launches), from torch.profiler's device events: each
    kernel's mean duration over the launches the profiler caught, which
    need not be all ``reps`` of them, times its launches per call.  A
    padded window can still come back with none of them (3 of 11 in one
    run of this script on an H100), so an empty window is logged and
    profiled again, up to ``PROFILE_TRIES`` windows; None where none caught
    any."""
    patterns = ((kernel_name,) if isinstance(kernel_name, str)
                else kernel_name)
    fn()
    for tries in range(1, PROFILE_TRIES + 1):
        with _profile() as prof:
            for _ in range(reps):
                fn()
        by = {}                                 # name: [us, events]
        for ev in _device_events(prof):
            if any(p in ev.name for p in patterns):
                entry = by.setdefault(ev.name, [0.0, 0])
                entry[0] += ev.time_range.elapsed_us()
                entry[1] += 1
        total = sum(us / n * max(1, round(n / reps))
                    for us, n in by.values())
        if total > 0:
            return total / 1000.0
        _log(f'profiler window {tries} of {PROFILE_TRIES} caught no launch '
             f'of {patterns}')
    return None


def _device_events(prof):
    """The card's operations (kernels, copies, memsets) among a profile's
    events: not the ``record_function`` spans, which the profiler mirrors
    on the device's timeline.  The port's ``nr.*`` spans are the
    profiler's fast records and show on the host's timeline alone; a
    ``nr.`` name on the device's is still left out."""
    from torch.autograd import DeviceType
    return [ev for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, 'is_user_annotation', False)
            and not ev.name.startswith(tracing.PREFIX)]


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
    with _profile() as prof:
        t0 = time.perf_counter()
        for eye in eyes:
            step(eye)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = 0.0
    by = {k: [0.0, 0, set()] for k in PROFILED}   # us, events, kernels
    for ev in _device_events(prof):
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
    ops = {'kernels': 0, 'copies': 0, 'memsets': 0}
    for ev in _device_events(prof):
        ops['copies' if 'Memcpy' in ev.name else
            'memsets' if 'Memset' in ev.name else 'kernels'] += 1
    return {k: v / n for k, v in ops.items()}


def _device_ops(fn, reps=5):
    """Device operations per call of ``fn``, from torch.profiler (which
    may drop an event now and then)."""
    fn()
    with _profile() as prof:
        for _ in range(reps):
            fn()
    return _op_counts(prof, reps)


def _op_name(name):
    """A profiler event's name without its namespaces, template arguments
    and parameters: 'bin_count_kernel', 'DeviceScanKernel', 'Memcpy DtoH'."""
    name = name.replace('(anonymous namespace)::', '')
    name = name[5:] if name.startswith('void ') else name
    return name.split('<')[0].split('(')[0].split('::')[-1].strip()


def _op_times(fn, reps=10, name=_op_name):
    """{device operation: ms per call of ``fn``} over ``reps`` calls after
    one more, from torch.profiler; operations go by ``name`` of their
    profiler names (by default cut to the function's own name)."""
    fn()
    with _profile() as prof:
        for _ in range(reps):
            fn()
    by = {}
    for ev in _device_events(prof):
        key = name(ev.name)
        by[key] = by.get(key, 0.0) + ev.time_range.elapsed_us()
    return {k: us / reps / 1e3 for k, us in by.items()}


def _top_device_ops(fn, n=6):
    """The ``n`` device operations (kernels, copies, memsets) that take
    the most time in one call of ``fn``, from torch.profiler: [(name, ms
    summed over the call)]."""
    ops = _op_times(fn, reps=1, name=lambda full: full)
    return sorted(ops.items(), key=lambda kv: -kv[1])[:n]


def _binning_times(name, settings, faces, tile, smi):
    """The setup and binning of ``faces`` at ``tile`` as ``forward_shaded``
    runs it, against ``bin_setup_plain`` in turns (kernel, plain, kernel,
    plain): {ms, plain_ms, alone_ms (its device operations, profiler),
    sync_wait_ms (the call less its device time: the pair total's readback
    and what the host does around it), op_ms (each device operation),
    device_ops, plain_device_ops}."""
    def binning():
        return forward_cuda.bin_setup(settings, faces, tile)

    def binning_plain():
        return forward_cuda.bin_setup_plain(settings, faces, tile)

    b1 = _time_ms(binning, reps=20, warmup=3)
    bp1 = _time_ms(binning_plain, reps=5, warmup=1)
    b2 = _time_ms(binning, reps=20)
    bp2 = _time_ms(binning_plain, reps=5)
    alone = _kernel_device_ms(binning, 10, BINNING_OPS)
    ops, plain_ops = _device_ops(binning), _device_ops(binning_plain)
    op_ms = _op_times(binning)
    out = dict(ms=b1, plain_ms=bp1, alone_ms=alone,
               sync_wait_ms=None if alone is None else b1 - alone,
               op_ms=op_ms, device_ops=sum(ops.values()),
               plain_device_ops=sum(plain_ops.values()))
    _log(f'setup + binning {name} on {smi}: bin_setup {b1:.3f} / {b2:.3f} '
         f'ms, plain {bp1:.3f} / {bp2:.3f} ms (kernel, plain, kernel, '
         f'plain); its device operations alone (profiler) {_fmt_ms(alone)}, '
         f'the sync\'s wait {_fmt_ms(out["sync_wait_ms"])}; per call '
         f'{_fmt_ops(ops)}, plain {_fmt_ops(plain_ops)}; per device '
         'operation ' + ', '.join(f'{k} {v:.4f} ms' for k, v in op_ms.items()))
    return out


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


def _reduce_work(pixels, covered, channels, ts, faces):
    """(bytes, operations) the per-face reduction needs at the least: the
    face map read at every raster pixel; at each covered pixel the stack's
    ``channels`` and, with the K6 cells of a ``ts`` cube, the 10 map words
    the factors are built from (z 3, weights 3, depth 1, rgb gradient 3);
    the ``[faces, channels + 3 ts^3]`` sums written once.  Operations: an
    add a channel and, per cell column, two products and an add."""
    cols = channels + 3 * ts ** 3
    words = channels + (10 if ts else 0)
    return (4 * pixels + 4 * words * covered + 4 * faces * cols,
            covered * (channels + 9 * ts ** 3))


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


def _sum_image_grads(bs, is_, dev, key='rgb'):
    """The output gradients of ``sum(image)`` as autograd hands them to
    the rasterizer's rgb ``[bs, is, is, 3]`` (or, with ``key='alpha'``,
    its alpha ``[bs, is, is]``): through the vertical flip and the 2x2 mean
    pool of ``api._render_pass`` (``composite_pool.flip_pool``)."""
    s = RasterizeSettings(image_size=is_, return_rgb=key == 'rgb',
                          return_alpha=key == 'alpha', return_depth=False)
    x = torch.zeros((bs, is_, is_, 3) if key == 'rgb' else (bs, is_, is_),
                    device=dev, requires_grad=True)
    image = composite_pool.flip_pool(s, x, x, None, True)[key]
    g, = torch.autograd.grad(image.sum(), x)
    grads = dict(g_rgb=None, g_alpha=None, g_depth=None)
    grads[f'g_{key}'] = g
    return grads


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
    """The K5 (and K7) stack and the K6 maps (``backward_cuda.K6Maps``,
    None above ts 4 or without rgb) as ``RasterizeCore`` hands them to the
    reduction."""
    k5 = settings.return_rgb or settings.return_alpha
    k6 = (backward_cuda.K6Maps(settings, ts, maps['z'], maps['weights'],
                               maps['depth_map'], grads['g_rgb'])
          if settings.return_rgb and ts <= backward_cuda.MAX_FACTOR_TS
          else None)
    stack = core.channel_stack(settings, maps, grads['g_rgb'],
                               grads['g_alpha'], grads['g_depth'], k5,
                               settings.return_depth)
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
    msg.append(f'face_reduce [{stack.shape[1]} ch'
               + ('' if k6 is None else f' + K6 of ts {k6.ts}')
               + f' -> {got.shape[1]} cols] '
               f'max abs err {err} ({ratio:.3g} x column max); repeat '
               'runs bitwise equal')
    _log(' '.join(msg))
    return got


def _compare_segments(name, ids, nseg, rng, dev):
    """The segmented sum against its plain version on random rows
    ``[len(ids), 3]`` summed onto ``ids``: within ``SEGMENT_TOL`` x the
    column's max |value|, a repeat run bitwise equal.  Returns (rows, perm,
    offsets, max abs error)."""
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
    return rows, perm, offsets, float(err.max())


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


def _load_script(path):
    """Import a script of the repository (an example, a misc/ study) by
    its path."""
    name = 'smoke_' + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _count_steps(module, record):
    """Wrap ``module.step`` so that each call appends (the kernel launches
    it made, its wall seconds up to a synchronize) to ``record``."""
    inner = module.step

    def step(*args, **kwargs):
        before = _launches()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = _launches()
        record.append(({k: after[k] - before[k] for k in after}, seconds))
        return out

    module.step = step


def _run_script(module, argv):
    """``module.run(argv)`` with its printed progress kept aside: (its
    result, wall seconds, its launches, its last printed line).  The
    progress is printed if the run raises."""
    buf = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = module.run(argv)
        torch.cuda.synchronize()
    except BaseException:
        _log(buf.getvalue())
        raise
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    return out, wall, _launches(), lines[-1] if lines else ''


def _check_gif(path):
    with open(path, 'rb') as fh:
        data = fh.read()
    _require(data[:6] == b'GIF89a' and data[-1:] == b'\x3b',
             f'{path} is not a whole GIF')
    return len(data)


def _near(got, want, rtol):
    return abs(got - want) <= rtol * abs(want)


def _grad_check(name, got, want, tol=FINGERPRINT_TOL):
    """|card - plain| <= tol x max |plain|; returns the worst error over
    that max."""
    got, want = got.detach().cpu(), want.detach()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    _require(bool(torch.isfinite(got).all()) and scale > 0
             and err <= tol * scale,
             f'{name}: the card differs from the plain version by {err} '
             f'(max |grad| {scale}, tolerance {tol} x max)')
    return err / scale


def _binning_metric():
    """The benchmark's reader of ``binning_roofline.sil``, whose
    ``binning_work`` counts what the tile lists need."""
    from benchmark import harness
    return harness.reader('binning_roofline.sil', ROOT)


def _large_mesh_phase(dev, smi, seed):
    """Phase 12's training steps: ``LARGE_CELL`` at its own shape, driven
    by the benchmark's ``harness.Program`` (``Renderer.render_silhouettes``
    and the gradient of the images' sum to the vertices, one step per
    azimuth).  Every hand-written training kernel launches once a step and
    no other; the binning's work counts equal the shape's faces and (tile,
    chunk) cells and, for the pairs, the port's own padded tile boxes of
    each eye, which hold at least the pairs ``binning_roofline.sil``
    counts on the reference's faces."""
    from benchmark import harness
    from benchmark.reference import renderer as bref
    bench = harness.load_bench(ROOT)
    _, cfg, mix = harness.load_cell(bench, LARGE_CELL, ROOT)
    prog = harness.Program(nt, cfg, mix, seed, dev)
    bs, steps = mix['batch'], len(prog.eyes)
    prog.call(0)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        sil, grads = prog.call(i)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    counts = tracing.counts()
    launches = _launches()
    for name in LAUNCHED:
        want = steps if name in TRAINING_KERNELS else 0
        _require(launches[name] == want,
                 f'large-mesh steps launched {name} {launches[name]} times '
                 f'in {steps} steps; want {want}')
    g = grads['vertices']
    _require(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
             'large-mesh vertex gradient non-finite or zero')
    _require(float(sil.amax()) == 1.0, 'an empty icosphere silhouette')

    is_ = bref.raster_size(cfg)
    settings = RasterizeSettings(image_size=is_)
    tile = _build.library('forward_shaded').nr_forward_shaded_tile()
    nt_ = -(-is_ // tile)
    nf2 = 2 * prog.faces.shape[1]
    cells = bs * nt_ * nt_ * -(-nf2 // forward_cuda.BIN_CHUNK)
    _require(counts.get('work.faces') == steps * bs * nf2,
             f"work.faces {counts.get('work.faces')}; want "
             f'{steps * bs * nf2}')
    _require(counts.get('work.bin_cells') == steps * cells,
             f"work.bin_cells {counts.get('work.bin_cells')}; want "
             f'{steps} x {cells}')
    metric = _binning_metric()
    padded, need, least = 0, 0, 0.0
    with torch.no_grad():
        for i in range(steps):
            prog.renderer.eye = eye = prog.eye(i)
            fc = prog.renderer._camera_faces(prog.vertices[:1],
                                             prog.faces[:1])
            padded += bs * int(forward_cuda._pairs(settings, fc, tile)[0]
                               .sum())
            ref_fc = bref.raster_faces(cfg, mix['entry'], prog.vertices[:1],
                                       prog.faces[:1], eye)
            w = metric.binning_work(ref_fc, is_,
                                    torch.tensor([bs], device=dev))
            need += w['pairs']
            least += _bound(w['bytes'], w['ops'])[0] / steps
    _require(counts.get('work.bin_pairs') == padded,
             f"work.bin_pairs {counts.get('work.bin_pairs')}; the port's "
             f'padded tile boxes hold {padded}')
    _require(need <= padded, f'binning_roofline.sil counts {need} pairs, '
             f'more than the {padded} of the padded boxes')
    waits = {k[5:]: v / steps for k, v in counts.items()
             if k.startswith('wait.')}
    _log(f'large mesh (training, {LARGE_CELL}): nf {nf2}, {steps} steps x '
         f'batch {bs}, {cfg["image_size"]}^2 AA, render_silhouettes + the '
         f'gradient of sum() w.r.t. vertices: {elapsed:.4f} s, '
         f'{steps * bs / elapsed:.2f} training images/s on {smi}; peak '
         f'{peak} bytes; launches {launches}; host waits a step {waits}; '
         f'max |grad| {float(g.abs().max()):.6g}')
    _log(f'large mesh binning a step: {cells} (tile, chunk) cells, '
         f'{padded // steps} pairs in the padded boxes against '
         f'{need // steps} that binning_roofline.sil counts '
         f'({padded / max(need, 1):.4f}x; the +-1 pixel pad for rounding); '
         f'its bound {least:.4f} ms by bytes')


def _examples_phase(dev, smi):
    """Phase 17: the four examples' ``run`` with their defaults on the card
    (outputs into a temporary directory), their step-0 losses, convergence
    and kernel launches per training step, a profile of each training
    example's step, then each one's step-0 gradient against the plain
    versions on the CPU.  Returns {example: its run's launches}."""
    mods = {n: _load_script(os.path.join(EXAMPLES, f'torch_example{n}.py'))
            for n in (1, 2, 3, 4)}
    steps = {n: [] for n in (2, 3, 4)}
    for n, record in steps.items():
        _count_steps(mods[n], record)
    ref3 = imread(os.path.join(EXAMPLE_DATA, 'example3_ref.png'))
    step0 = dict(STEP0_LOSS)
    step0[3] = float(np.sum(np.square(ref3.astype(np.float64) / 255.0)))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = {1: ['-o', f'{tmp}/example1.gif'],
                2: ['-oo', f'{tmp}/example2_optimization.gif',
                    '-or', f'{tmp}/example2_result.gif'],
                3: ['-or', f'{tmp}/example3_result.gif'],
                4: ['-or', f'{tmp}/example4_result.gif']}
        for n in (1, 2, 3, 4):
            out, wall, launches[f'example{n}'], last = _run_script(mods[n],
                                                                   argv[n])
            sizes = [_check_gif(a) for a in argv[n] if a.endswith('.gif')]
            counts = launches[f'example{n}']
            if n == 1:
                nonblack = (out.max(1) > 0).mean((1, 2))
                _require(out.shape == (90, 3, OUT_SIZE, OUT_SIZE)
                         and bool(np.isfinite(out).all())
                         and float(nonblack.min()) > 0.05
                         and counts['forward_shaded'] >= 90,
                         f'example 1: {out.shape} frames, finite '
                         f'{bool(np.isfinite(out).all())}, least teapot '
                         f'cover {float(nonblack.min())}, launches {counts}')
                _log(f'example 1: 90 frames at {OUT_SIZE}^2 AA, finite, the '
                     f'teapot covering {float(nonblack.min()):.3f}-'
                     f'{float(nonblack.max()):.3f} of each; {wall:.2f} s wall '
                     f'({90 / wall:.2f} frames/s with the PNG frames and the '
                     f'GIF, {sizes[0]} bytes) on {smi}; launches {counts}')
                continue
            losses = out
            record = steps[n]
            _require(len(record) == len(losses), f'example {n}: {len(losses)} '
                     f'losses from {len(record)} steps')
            for i, (step_launches, _) in enumerate(record):
                _require(all(step_launches[k] >= 1 for k in TRAINING_KERNELS),
                         f'example {n} step {i} launched {step_launches}')
            _require(all(np.isfinite(losses))
                     and _near(losses[0], step0[n], STEP0_RTOL),
                     f'example {n}: step-0 loss {losses[0]}, expected '
                     f'{step0[n]} (rtol {STEP0_RTOL})')
            if n == 2:
                _require(len(losses) == 300 and losses[-1] < EX2_LAST_BELOW,
                         f'example 2: loss {losses[-1]} after {len(losses)} '
                         f'steps, expected below {EX2_LAST_BELOW} after 300')
            elif n == 3:
                tail = losses[EX3_FROM_STEP:]
                worst = EX3_FROM_STEP + int(np.argmax(tail))
                _require(len(losses) == 300 and min(tail) >= EX3_BAND[0]
                         and max(tail) <= EX3_BAND[1],
                         f'example 3: from step {EX3_FROM_STEP} the loss '
                         f'spans {min(tail)}-{max(tail)} (the most at step '
                         f'{worst}), expected within {EX3_BAND}')
            else:
                _require(losses[-1] < mods[4].STOP_LOSS
                         and len(losses) <= 1000,
                         f'example 4: loss {losses[-1]} after {len(losses)} '
                         f'steps, expected below {mods[4].STOP_LOSS} within '
                         '1000')
            step_s = sum(s for _, s in record)
            band = (f'; from step {EX3_FROM_STEP} '
                    f'{min(losses[EX3_FROM_STEP:]):.4f}-'
                    f'{max(losses[EX3_FROM_STEP:]):.4f}' if n == 3 else '')
            _log(f'example {n}: {len(losses)} steps, loss {losses[0]:.4f} '
                 f'(step 0; expected {step0[n]}) -> {losses[-1]:.4f} '
                 f'(last){band}; {len(losses) / step_s:.2f} steps/s over the '
                 f'steps, {wall:.2f} s wall with the frames and GIFs '
                 f'({", ".join(map(str, sizes))} bytes) on {smi}; every step '
                 f'launched {", ".join(TRAINING_KERNELS)}; launches {counts}; '
                 f'its last line: {last}')

    # where a training example's step spends its time: 10 steps of each
    # under torch.profiler, against the run's own unprofiled steps
    obj = os.path.join(EXAMPLE_DATA, 'teapot.obj')
    refs = {n: os.path.join(EXAMPLE_DATA, f'example{n}_ref.png')
            for n in (2, 3, 4)}
    mesh2, r2, ref2 = mods[2].build(obj, refs[2], dev)
    opt2 = nt.Adam(mesh2.lr_scales())
    mesh3, r3, ref3 = mods[3].build(obj, refs[3], dev)
    opt3 = nt.Adam(mesh3.lr_scales(), alpha=0.1, beta1=0.5)
    v4, f4, _, r4, ref4, eye4 = mods[4].build(obj, refs[4], dev)
    init4, update4 = nt.adam(alpha=0.1)
    state4 = [init4({'eye': eye4})]

    def step4(_):
        state4[0] = mods[4].step(eye4, state4[0], update4, r4, v4, f4,
                                 ref4)[1]

    profiled = {2: lambda _: mods[2].step(mesh2, r2, ref2, opt2),
                3: lambda azimuth: mods[3].step(mesh3, r3, ref3, opt3,
                                                azimuth),
                4: step4}
    for n, fn in profiled.items():
        run_ms = 1e3 * np.mean([s for _, s in steps[n]])
        fn(0.0)                                   # warm-up
        prof = _step_profile(fn, [float(a) for a in range(0, 360, 36)])
        if prof is None:
            _log(f'example {n} step profile: the profiler reported no '
                 'device time (not measured)')
            continue
        dev_ms, wall_ms, by, ops = prof
        _log(f'example {n} step profile (torch.profiler, 10 steps) on {smi}: '
             f'device {dev_ms:.3f} ms per step, {_fmt_ops(ops)}; against '
             f'the run\'s {run_ms:.3f} ms per step the card idles '
             f'{100 * (1 - dev_ms / run_ms):.1f}% (profiled wall '
             f'{wall_ms:.3f} ms); per step '
             + ', '.join(f'{k} {v:.3f} ms' for k, v in by.items()))
    del mesh2, mesh3, v4, f4, eye4, state4

    # each training example's step 0 on the card and through the plain
    # versions on the CPU, from the same files
    t0 = time.perf_counter()
    grads = {}
    for device in (dev, torch.device('cpu')):
        mesh, renderer, image_ref = mods[2].build(obj, refs[2], device)
        mods[2].loss_fn(mesh, renderer, image_ref).backward()
        grads.setdefault('vertices (example 2)', []).append(mesh.vertices.grad)
        mesh, renderer, image_ref = mods[3].build(obj, refs[3], device)
        # the first azimuth of run's default --seed 0
        azimuth = np.random.default_rng(0).uniform(0, 360)
        mods[3].loss_fn(mesh, renderer, image_ref, azimuth).backward()
        grads.setdefault('textures (example 3)', []).append(mesh.textures.grad)
        v, f, _, renderer, image_ref, eye = mods[4].build(obj, refs[4],
                                                          device)
        g, = torch.autograd.grad(
            mods[4].loss_fn(eye, renderer, v, f, image_ref), eye)
        grads.setdefault('eye (example 4)', []).append(g)
    ratios = {name: _grad_check(f'example step-0 gradient of the {name}',
                                *pair) for name, pair in grads.items()}
    _log('examples\' step-0 gradients, the card against the plain versions '
         'on the CPU: ' + ', '.join(f'{k} {r:.3g} x max |grad|'
                                   for k, r in ratios.items())
         + f' (tolerance {FINGERPRINT_TOL} x max; eye gradient card '
         f'{grads["eye (example 4)"][0].tolist()}, CPU '
         f'{grads["eye (example 4)"][1].tolist()}); '
         f'{time.perf_counter() - t0:.1f} s')
    return launches


def _grad_quality_phase(smi):
    """Phase 18: misc/torch_grad_quality.py on the card against the JAX
    package's rows."""
    gq = _load_script(os.path.join(ROOT, 'misc', 'torch_grad_quality.py'))
    (rows, g_brighter, g_darker), wall, counts, _ = _run_script(gq, [])
    _require([r[0] for r in rows] == list(GRAD_QUALITY),
             f'grad quality: rows of pixels {[r[0] for r in rows]}')
    for px, mag, gx in rows:
        want = GRAD_QUALITY[px]
        _require(_near(mag, want[0], GRAD_QUALITY_RTOL)
                 and _near(gx, want[1], GRAD_QUALITY_RTOL),
                 f'grad quality pixel {px}: max |grad| {mag}, d/d(v0.x) {gx}, '
                 f'expected {want} (rtol {GRAD_QUALITY_RTOL})')
    _require(bool(np.all(g_darker == 0)) and g_brighter[0, 0] > 0,
             'grad quality: pixel 12\'s "darker" gradient is not exactly 0 '
             'or its "brighter" one not positive')
    worst = max(max(abs(m / GRAD_QUALITY[p][0] - 1),
                    abs(x / GRAD_QUALITY[p][1] - 1)) for p, m, x in rows)
    _log(f'grad quality: 8 rows within {worst:.3g} (relative) of the JAX '
         f'package\'s (rtol {GRAD_QUALITY_RTOL}): '
         + ', '.join(f'{p}: {m:.5f} / {x:+.5f}' for p, m, x in rows)
         + f'; pixel 12 "brighter" {g_brighter[0, 0]:+.5f}, "darker" '
         f'exactly 0; {wall:.2f} s on {smi}; launches {counts}')


def _maps_vs_cpu(name, settings, faces, textures):
    """The forward kernel's maps against its plain version on CPU copies of
    the same inputs: face_index_map equal, the other maps within phase 3's
    tolerances.  Returns ({map: bit-equal}, worst abs error)."""
    got = forward_cuda.forward_shaded(settings, faces, textures)
    want = forward_cuda.forward_shaded_plain(settings, faces.cpu(),
                                             textures.cpu())
    mism = int((got['face_index_map'].cpu() != want['face_index_map']).sum())
    _require(mism == 0, f'{name}: {mism} face_index_map mismatches against '
             'the plain version on the CPU')
    equal, worst = {}, 0.0
    for key in ('depth_map', 'weights', 'xy', 'z', 'rgb'):
        a, b = got[key].cpu(), want[key]
        rtol, atol = (RGB_RTOL, RGB_ATOL) if key == 'rgb' else (RTOL, ATOL)
        _require(torch.allclose(a, b, rtol=rtol, atol=atol),
                 f'{name}: {key} differs from the plain version on the CPU '
                 f'by {float((a - b).abs().max())}')
        equal[key] = _bits_equal(a, b)
        worst = max(worst, float((a - b).abs().max()))
    return equal, worst


def _render_phase(dev, smi, rng, bworst):
    """Phase 19: misc/torch_render.py at its defaults over tests/data, then
    the real model (every covered pixel a depth tie) through every kernel:
    the forward maps against the plain versions (on CPU copies and on the
    card) with batched views bit-equal to single ones, a training step's
    backward kernels against theirs, repeat steps bitwise equal, and tune
    with the index kernel against its plain version.  Updates ``bworst``;
    returns ({path: its launches}, forward worst error, index worst
    error)."""
    tr = _load_script(os.path.join(ROOT, 'misc', 'torch_render.py'))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, wall, launches['torch_render'], _ = _run_script(
            tr, ['-i', DATA, '-o', tmp])
        meshes = sorted(glob.glob(os.path.join(DATA, '**', '*.obj'),
                                  recursive=True))
        names = [os.path.splitext(os.path.relpath(m, DATA))[0].replace(
            os.sep, '_') + f'_{vi:02d}.png' for m in meshes for vi in range(24)]
        _require([os.path.basename(p) for p in paths] == names
                 and sorted(os.listdir(tmp)) == sorted(names),
                 f'torch_render wrote {len(paths)} PNGs for {len(meshes)} '
                 'meshes, not the 24 views of each under their names')
        cover = {}
        for p in paths:
            image = imread(p)
            _require(image.shape == (OUT_SIZE, OUT_SIZE, 3)
                     and image.dtype == np.uint8,
                     f'{p}: {image.shape} {image.dtype}')
            cover[os.path.basename(p)] = float((image.max(-1) > 12).mean())
        _require(min(cover.values()) > 0.01,
                 f'a view shows almost nothing: {min(cover, key=cover.get)}')
    counts = launches['torch_render']
    _require(counts['forward_shaded'] >= len(meshes)
             and counts['bin_faces'] >= len(meshes),
             f'torch_render launched {counts}')
    _log(f'torch_render: {len(paths)} PNGs of {len(meshes)} meshes (24 '
         f'views each at {OUT_SIZE}^2 AA, ts 2, up to {tr.MAX_VIEWS} views a '
         f'call), each read back ({min(cover.values()):.3f}-'
         f'{max(cover.values()):.3f} of a view covered); {wall:.2f} s wall, '
         f'{len(paths) / wall:.2f} images/s with the OBJ and JPEG loads and '
         f'the PNG writes, on {smi}; launches {counts}')

    # the model's 24 views in one call, as the script renders them
    vm, fm, tm = tr.load_mesh(MODEL, 2, dev)
    eyes24 = tr.view_eyes(24, DISTANCE, ELEVATION, dev)
    renderer = nt.Renderer()
    renderer.image_size = OUT_SIZE

    def views():
        return tr.render_views(renderer, vm, fm, tm, eyes24)

    batched = views()
    single = np.concatenate([tr.render_views(renderer, vm, fm, tm,
                                             eyes24[i:i + 1])
                             for i in range(24)])
    _require(np.array_equal(batched, single), 'the model\'s 24 views in one '
             'call differ from one view per call')
    t0 = time.perf_counter()
    for _ in range(3):
        views()
    call_ms = (time.perf_counter() - t0) * 1e3 / 3
    prof = _step_profile(lambda _: views(), range(3))
    if prof is None:
        _log('torch_render call profile: the profiler reported no device '
             'time (not measured)')
    else:
        dev_ms, wall_ms, by, ops = prof
        _log(f'torch_render call (the model, 24 views, {OUT_SIZE}^2 AA, '
             f'ts 2, images copied to the host) on {smi}: {call_ms:.3f} ms '
             f'a call; torch.profiler over 3 calls: device {dev_ms:.3f} ms '
             f'a call, {_fmt_ops(ops)}; the card idles '
             f'{100 * (1 - dev_ms / call_ms):.1f}% (profiled wall '
             f'{wall_ms:.3f} ms); forward kernel {by["forward_shaded"]:.3f} '
             'ms a call; the largest device operations of one call: '
             + ', '.join(f'{k[:60]} {ms:.3f} ms'
                         for k, ms in _top_device_ops(views)))

    # the kernel's maps: bit-equal between batch and single views, against
    # the plain version on the card (24 views) and on the CPU (2 views)
    renderer.eye = eyes24
    fc24, tx24 = renderer._lit_faces(vm.expand(24, -1, -1),
                                     fm.expand(24, -1, -1),
                                     tm.expand((24,) + tm.shape[1:]))
    s512 = RasterizeSettings(image_size=RASTER, eps=1e-3)
    whole = forward_cuda.forward_shaded(s512, fc24, tx24)
    for i in range(24):
        one = forward_cuda.forward_shaded(s512, fc24[i:i + 1],
                                          tx24[i:i + 1])
        for key in ('face_index_map', 'depth_map', 'weights', 'xy', 'z',
                    'rgb'):
            a, b = whole[key][i:i + 1], one[key]
            _require(torch.equal(a, b) if key == 'face_index_map'
                     else _bits_equal(a, b),
                     f'model view {i}: {key} of the batch differs from the '
                     'single view')
    fim = whole['face_index_map']
    nf_model = fm.shape[1]
    covered = fim >= 0
    own = int((fim[covered] < nf_model).sum())
    fworst = _compare(f'model {RASTER}^2 bs 24 ts 2 (all ties)', s512, fc24,
                      tx24)
    t0 = time.perf_counter()
    cpu_equal, cpu_worst = _maps_vs_cpu(
        f'model {RASTER}^2 views 0 and 9', s512, fc24[[0, 9]],
        tx24[[0, 9]])
    _log(f'model forward maps at {RASTER}^2, 24 views: face_index_map of the '
         f'kernel equal to the plain version on the card; batched views '
         f'bit-equal to single ones; {int(covered.sum())} covered pixels, '
         f'{own} won by one of the model\'s own {nf_model} faces, the rest by '
         f'a back-filled copy; views 0 and 9 against the '
         f'plain version on CPU copies: index equal, bit-equal {cpu_equal}, '
         f'max abs err {cpu_worst:.3g} ({time.perf_counter() - t0:.1f} s)')

    # a training step on 32 views: the backward kernels against their plain
    # versions, repeat steps bitwise equal
    eyes32 = tr.view_eyes(BATCH, DISTANCE, ELEVATION, dev)
    trainer = nt.Renderer()
    trainer.image_size = OUT_SIZE
    trainer.eye = eyes32
    f32 = fm.expand(BATCH, -1, -1)
    fc32, tx32 = trainer._lit_faces(vm.expand(BATCH, -1, -1), f32,
                                    tm.expand((BATCH,) + tm.shape[1:]))
    s_rgb = RasterizeSettings(image_size=RASTER, eps=1e-3, return_alpha=False,
                              return_depth=False)
    nf2 = fc32.shape[1]
    maps, grads = _bwd_scene(s_rgb, fc32, tx32, rng, dev)
    _compare_backward(f'model {RASTER}^2 bs {BATCH} ts 2 rgb', s_rgb, maps,
                      grads, nf2, 2, bworst)
    _compare_backward(f'model {RASTER}^2 bs {BATCH} ts 2 rgb, sum(image)',
                      s_rgb, maps, _sum_image_grads(BATCH, RASTER, dev), nf2,
                      2, bworst)
    del maps, grads, fc32, tx32
    vg = vm.repeat(BATCH, 1, 1).requires_grad_()
    tg = tm.repeat(BATCH, 1, 1, 1, 1, 1).requires_grad_()

    def step():
        vg.grad = None
        tg.grad = None
        image = trainer.render(vg, f32, tg)
        (image * torch.sin(image)).sum().backward()
        return vg.grad.clone(), tg.grad.clone()

    step()                                        # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    first = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches['model_step'] = _launches()
    _require(all(launches['model_step'][k] >= 1 for k in TRAINING_KERNELS),
             f'the model\'s training step launched {launches["model_step"]}')
    _require(_grads_equal(first, step()), 'two training steps of the model '
             'gave different gradients')
    _require(_grads_ok(first), 'the model\'s gradients are not finite and '
             'non-zero')
    _log(f'model training step: {BATCH} views at {OUT_SIZE}^2 AA, ts 2, '
         f'sum(image * sin(image)) to vertices and textures: {step_ms:.3f} ms '
         f'on {smi}; two steps bitwise equal, gradients finite (the 8 '
         f'zero-area faces included); launches {launches["model_step"]}')
    del vg, tg, first

    # tune on the model over the 8 bench azimuths, and the index kernel
    tuner = nt.Renderer()
    tuner.image_size = OUT_SIZE
    bench_eyes = [nt.get_points_from_angles(DISTANCE, ELEVATION, a)
                  for a in AZIMUTHS]
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    overrides = nt.tune(tuner, vm[0], fm[0], eyes=bench_eyes)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches['model_tune'] = _launches()
    _require(launches['model_tune']['forward_index'] >= len(bench_eyes),
             f'tune on the model launched {launches["model_tune"]}')
    iworst = _compare_index(f'model {RASTER}^2 bs 24 (all ties)', s512, fc24)
    _log(f'model tune over {len(bench_eyes)} azimuths, {OUT_SIZE}^2 AA: '
         f'{overrides} in {tune_s:.4f} s on {smi}; launches '
         f'{launches["model_tune"]}')
    return launches, max(fworst, cpu_worst), iworst


def _protocol_phase(dev, smi, rng, bworst):
    """Phase 20: misc/torch_measure_time.py at its defaults, the reference
    protocol (the teapot at batch 1, 256^2 AA, ts 2, azimuths 0-345 by 15,
    the first sample dropped); one silhouette and one textured forward +
    backward call profiled over the 24 azimuths; the card's images and
    gradients at azimuths 0 and 45 against the same functions on the CPU;
    the three backward kernels (updating ``bworst``) and the segmented sum
    against their plain versions at the shapes the protocol's calls give
    them.  Returns ({path: its launches}, the segmented sum's max abs
    error)."""
    mt = _load_script(os.path.join(ROOT, 'misc', 'torch_measure_time.py'))
    means, wall, counts, _ = _run_script(mt, [])
    n = len(mt.AZIMUTHS)
    _require(all(np.isfinite(means)) and min(means) > 0,
             f'measure_time: means {means}')
    for k in TRAINING_KERNELS:
        want = 4 * n if k in ('forward_shaded', 'bin_faces') else 2 * n
        _require(counts[k] >= want, f'measure_time launched {k} {counts[k]} '
                 f'times in {4 * n} calls, {2 * n} of them backward')
    _log(f'reference protocol (misc/torch_measure_time.py: teapot bs 1, '
         f'{OUT_SIZE}^2 AA, ts 2, {n} azimuths, first sample dropped) on '
         f'{smi}: ' + ', '.join(f'{k} {ms:.3f} ms'
                                for k, ms in zip(mt.KINDS, means))
         + f'; {wall:.2f} s wall; launches {counts}')

    card = mt.build(mt.parse_args([]))
    eyes = [mt.eye_at(a, dev) for a in mt.AZIMUTHS]
    for kind, call, call_ms in ((mt.KINDS[1], card[1], means[1]),
                                (mt.KINDS[3], card[3], means[3])):
        call(eyes[0])                             # warm-up
        _reset_launches()
        call(eyes[1])
        torch.cuda.synchronize()
        per_call = {k: v for k, v in _launches().items() if v}
        prof = _step_profile(call, eyes)
        if prof is None:
            _log(f'{kind} call profile: the profiler reported no device time '
                 '(not measured)')
            continue
        dev_ms, wall_ms, by, ops = prof
        _log(f'{kind} call (forward + backward of sum(image)) profiled over '
             f'{n} azimuths on {smi}: device {dev_ms:.3f} ms a call, '
             f'{_fmt_ops(ops)}; against the protocol\'s {call_ms:.3f} ms the '
             f'card idles {100 * (1 - dev_ms / call_ms):.1f}% (profiled wall '
             f'{wall_ms:.3f} ms); the hand kernels\' launches per call '
             f'{per_call}; per call '
             + ', '.join(f'{k} {v:.3f} ms' for k, v in by.items()))

    # the card against the plain versions on the CPU, the same functions
    t0 = time.perf_counter()
    cpu = mt.build(mt.parse_args(['--device', 'cpu']))
    worst = {}
    for azimuth in (0, 45):
        for kind, on_card, plain in zip(mt.KINDS, card, cpu):
            got = on_card(mt.eye_at(azimuth, dev))
            want = plain(mt.eye_at(azimuth, 'cpu'))
            name = f'measure_time {kind} at azimuth {azimuth}'
            if 'forward' in kind:
                rtol, atol = ((RGB_RTOL, RGB_ATOL) if kind.startswith('texture')
                              else (RTOL, ATOL))
                err = float((got.cpu() - want).abs().max())
                _require(torch.allclose(got.cpu(), want, rtol=rtol, atol=atol),
                         f'{name}: the card differs from the CPU by {err}')
                worst[kind] = max(worst.get(kind, 0.0), err)
                continue
            for part, g, w in zip(('vertices', 'textures'), got, want):
                key = f'{kind} {part}'
                worst[key] = max(worst.get(key, 0.0), _grad_check(
                    f'{name} ({part})', g, w, SUM_TOL))
    _log('reference protocol at azimuths 0 and 45, the card against the '
         f'plain versions on the CPU: images max abs err '
         + ', '.join(f'{k} {v:.3g}' for k, v in worst.items()
                     if 'forward' in k)
         + f' (silhouettes rtol {RTOL} atol {ATOL}, rgb rtol {RGB_RTOL} '
         f'atol {RGB_ATOL}); gradients '
         + ', '.join(f'{k} {v:.3g} x max' for k, v in worst.items()
                     if 'forward' not in k)
         + f' (tolerance {SUM_TOL} x max |grad|); '
         f'{time.perf_counter() - t0:.1f} s')

    # the backward kernels and the vertex scatter at the protocol's shapes:
    # the teapot at azimuth 45, batch 1, a 512^2 raster; the output
    # gradients of sum(image), and random ones (the silhouettes' sum gives
    # the out-sweep nothing to sum)
    args = mt.parse_args([])
    r = nt.Renderer()
    r.image_size = args.image_size
    r.eye = mt.eye_at(45, dev)
    vertices, faces = nt.load_obj(args.filename_input)
    v, f, t = nt.arrays_from_numpy(
        vertices[None], faces[None], np.ones(
            (1, faces.shape[0]) + (mt.TEXTURE_SIZE,) * 3 + (3,), np.float32),
        dev)
    fc, lit = r._lit_faces(v, f, t)
    raster, nf2 = 2 * args.image_size, fc.shape[1]
    for mode, rgb, textures in (('silhouettes', False, None),
                                ('textured', True, lit)):
        s = RasterizeSettings(
            image_size=raster, near=float(r.near), far=float(r.far),
            eps=float(r.rasterizer_eps), return_rgb=rgb,
            return_alpha=not rgb, return_depth=False)
        maps, grads = _bwd_scene(s, fc, textures, rng, dev)
        for kind, g in (('sum(image)', _sum_image_grads(
                1, raster, dev, 'rgb' if rgb else 'alpha')),
                        ('random', grads)):
            _compare_backward(
                f'measure_time {raster}^2 bs 1 ts {mt.TEXTURE_SIZE} {mode}, '
                f'{kind} output gradients, azimuth 45', s, maps, g, nf2,
                mt.TEXTURE_SIZE, bworst)
    ids = r._fill_back_faces(f.long()).reshape(-1)
    *_, seg_err = _compare_segments('measure_time vertices', ids,
                                    vertices.shape[0], rng, dev)
    _log(f'segment_sum measure_time vertices: {ids.shape[0]} rows onto '
         f'{vertices.shape[0]} vertices, max abs err {seg_err:.3g} '
         f'({SEGMENT_TOL} x column max), repeat run bitwise equal')
    return {'measure_time': counts}, seg_err


def _multiview_phase(dev, smi):
    """Phase 21: misc/torch_multiview.py at its defaults, BASELINE config
    5 (64 views of the teapot at 512^2 AA through ``render_rgbad``, tuned
    over 8 eyes, one warm-up and 4 timed calls over a one-rank group), its
    memory peak, one call profiled; the script's output bit-equal to
    ``render_rgbad`` in one call and in 8 calls of 8 views; the forward
    maps of all the views against the plain version on the card; the
    index kernel against its plain version on each of the 8 scenes ``tune``
    gives it, timed; the binning at this size against its plain version,
    timed.  Returns ({path: its launches}, forward worst error, index
    worst error)."""
    mv = _load_script(os.path.join(ROOT, 'misc', 'torch_multiview.py'))
    args = mv.parse_args([])
    nv, raster = args.views, 2 * args.image_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (out, timing), wall, counts, _ = _run_script(mv, [])
    run_peak = torch.cuda.max_memory_allocated()
    _require(counts['forward_index'] == 8,
             f'multiview\'s tune launched the index kernel '
             f'{counts["forward_index"]} times, not 8')
    _require(counts['forward_shaded'] >= 1 + args.iters,
             f'multiview launched {counts}')
    shapes = {k: tuple(out[k].shape) for k in ('rgb', 'alpha', 'depth')}
    _require(shapes == {'rgb': (nv, 3, args.image_size, args.image_size),
                        'alpha': (nv, args.image_size, args.image_size),
                        'depth': (nv, args.image_size, args.image_size)},
             f'multiview output shapes {shapes}')
    means = {k: float(out[k].mean()) for k in out}
    _log(f'BASELINE config 5 (misc/torch_multiview.py: {nv} views of the '
         f'teapot at {args.image_size}^2 AA, rgb + alpha + depth, '
         f'{timing["ranks"]} rank) on {smi}: {timing["ms_per_batch"]:.3f} '
         f'ms/batch, {timing["images_per_s"]:.2f} images/s over '
         f'{args.iters} calls; {wall:.2f} s wall with tune; outputs finite, '
         f'shapes {shapes}, means '
         + ', '.join(f'{k} {v:.4f}' for k, v in means.items())
         + f'; peak device memory {run_peak / 2 ** 30:.2f} GiB; launches '
         f'{counts}')

    renderer, v, f, tx, eyes = mv.build(args)
    with torch.no_grad():
        def render():
            return renderer.render_rgbad(v, f, tx)

        whole = render()
        for k in out:
            _require(_bits_equal(whole[k], out[k]),
                     f'multiview {k}: the script\'s one-rank render differs '
                     'from render_rgbad')
        for i in range(0, nv, 8):
            renderer.eye = eyes[i:i + 8]
            part = renderer.render_rgbad(v[i:i + 8], f[i:i + 8], tx[i:i + 8])
            for k in out:
                _require(_bits_equal(part[k], whole[k][i:i + 8]),
                         f'multiview {k}: views {i}-{i + 7} in a call of 8 '
                         f'differ from the call of {nv}')
        renderer.eye = eyes
        del out, part
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kept = render()
        call_peak = torch.cuda.max_memory_allocated() - base
        # under no_grad the rasterizer saves nothing for a backward: a call
        # holds its outputs and no map (one map plane is 256 MiB here)
        held = torch.cuda.memory_allocated() - base
        out_bytes = sum(x.numel() * x.element_size() for x in kept.values())
        _require(held - out_bytes < 2 ** 26,
                 f'multiview: a call under no_grad holds {held} bytes for '
                 f'{out_bytes} bytes of outputs')
        del kept
        prof = _step_profile(lambda _: render(), range(3))
        top = _top_device_ops(render)
        fc, lit = renderer._lit_faces(v, f, tx)
    call_ms = timing['ms_per_batch']
    if prof is None:
        _log('multiview call profile: the profiler reported no device time '
             '(not measured)')
    else:
        dev_ms, wall_ms, by, ops = prof
        _log(f'multiview call profiled (3 calls) on {smi}: device '
             f'{dev_ms:.3f} ms a call, {_fmt_ops(ops)}; against the '
             f'script\'s {call_ms:.3f} ms the card idles '
             f'{100 * (1 - dev_ms / call_ms):.1f}% (profiled wall '
             f'{wall_ms:.3f} ms); forward kernel {by["forward_shaded"]:.3f} '
             f'ms a call; a call\'s peak above what it was handed '
             f'{call_peak / 2 ** 30:.2f} GiB, what it holds after '
             f'{held} bytes ({out_bytes} of outputs); the largest device '
             'operations of one call: '
             + ', '.join(f'{k[:60]} {ms:.3f} ms' for k, ms in top))
    _log(f'multiview: {nv} views in one call bit-equal to {nv // 8} calls '
         f'of 8 and to the script\'s one-rank sharded render; the forward '
         f'kernel\'s '
         f'largest flat offset {nv * 17 * raster * raster - 1} (bs x 17 '
         f'words x {raster}^2) of int32\'s {2 ** 31 - 1}')

    # the forward maps of all the views against the plain version, timed
    s = RasterizeSettings(image_size=raster, eps=1e-3)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fworst = _compare(f'multiview {raster}^2 bs {nv} ts 2', s, fc, lit)
    cmp_s = time.perf_counter() - t0
    cmp_peak = torch.cuda.max_memory_allocated()

    def kernel():
        return forward_cuda.forward_shaded(s, fc, lit)

    def plain():
        return forward_cuda.forward_shaded_plain(s, fc, lit)

    ms = _time_ms(kernel, reps=10, warmup=2)
    plain_ms = _time_ms(plain, reps=1, warmup=0)
    alone = _kernel_device_ms(kernel, 5, 'shaded_kernel')
    _log(f'multiview forward maps at {raster}^2, {nv} views: equal to the '
         f'plain version (the comparison {cmp_s:.1f} s, peak device memory '
         f'{cmp_peak / 2 ** 30:.2f} GiB); forward_shaded {ms:.3f} ms a call, '
         f'alone {_fmt_ms(alone)}, plain {plain_ms:.3f} ms on {smi}')
    del kernel, plain
    torch.cuda.empty_cache()

    # the index kernel on the scenes tune gives it: every tuned eye's face
    # coords of all the views, alpha only, at the raster's size
    st = RasterizeSettings(image_size=raster, near=float(renderer.near),
                           far=float(renderer.far), return_rgb=False,
                           return_alpha=True, return_depth=False)
    fb = renderer._fill_back_faces(f.long())
    tuned = mv.tuned_eyes(eyes)
    iworst = 0.0
    t0 = time.perf_counter()
    with torch.no_grad():
        for k, eye in enumerate(tuned):
            renderer.eye = eye
            fct = vertices_to_faces(renderer._transform(v), fb)
            iworst = max(iworst, _compare_index(
                f'multiview tune eye {k}: {raster}^2 bs {nv}', st, fct))
    renderer.eye = eyes
    cmp_s = time.perf_counter() - t0
    index_ms = _time_ms(lambda: forward_cuda.forward_face_index_map(st, fct),
                        reps=10, warmup=2)
    index_plain_ms = _time_ms(
        lambda: forward_cuda.forward_face_index_map_plain(st, fct), reps=1,
        warmup=0)
    _log(f'multiview tune\'s index maps at {raster}^2, {nv} views, '
         f'{len(tuned)} eyes: equal to the plain version ({cmp_s:.1f} s); '
         f'forward_face_index_map {index_ms:.3f} ms a call, plain '
         f'{index_plain_ms:.3f} ms on {smi}')
    del fct, fb

    # the binning at this size: (tile, chunk) cells, the sync's wait
    tile = _build.library('forward_shaded').nr_forward_shaded_tile()
    cells = forward_cuda._bin_sizes(nv, fc.shape[1], raster, tile)[0]
    pairs = _compare_bins(f'multiview {raster}^2 bs {nv}', s, fc)
    times = _binning_times(f'of multiview, {nv} views at {raster}^2, nf '
                           f'{fc.shape[1]}', s, fc, tile, smi)
    _log(f'multiview binning: {cells} (tile, chunk) cells scanned, {pairs} '
         f'(tile, face) pairs; bin_setup {times["ms"]:.3f} ms a call, its '
         f'device operations {_fmt_ms(times["alone_ms"])}, the sync\'s wait '
         f'{_fmt_ms(times["sync_wait_ms"])}')
    return {'multiview': counts}, fworst, iworst


def _composite_pool_phase(dev, smi, rng):
    """Phase 22: the output pass's kernel (``composite_pool.composite_pool``)
    against its plain version on the card, bit for bit: adversarial maps
    (values over 48 binades, a quarter of the 2x2 windows all -0, a view
    with no covered pixel) in every layout the kernel takes (channel
    planes, planes with a larger batch stride as a face-group merge leaves
    them, channel-last), pooled and not, each output alone and all three,
    a [3] and a [bs, 3] background, at shapes that take the 16-byte path
    and shapes that do not; then BASELINE config 5's real maps (64 ring
    views, random textures, a 1024^2 raster, pooled and, at 512^2, not) and
    the main path's (bs 32, 512^2, rgb only), the kernel timed alone (CUDA
    events around bare launches into kept outputs), as the wrapper's call
    and against the plain version, with its byte bound; one config-5 call
    of ``render_rgbad`` under no_grad launches it once.  Returns the kernel
    line's entry: {ms, plain_ms, bound_ms, bound_by, alone_ms, launches,
    extras}."""
    plain, kernel = (composite_pool.composite_pool_plain,
                     composite_pool.composite_pool)
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))

    def adversarial(*shape):
        sign = torch.where(torch.rand(shape, generator=gen, device=dev)
                           < 0.5, -1.0, 1.0)
        scale = torch.exp2(torch.randint(-24, 25, shape, generator=gen,
                                         device=dev).float())
        return sign * scale * (1.0 + torch.rand(shape, generator=gen,
                                                device=dev))

    def plane_maps(*shape):
        """adversarial maps [..., is, is], every fourth 2x2 window -0"""
        zero = torch.zeros(shape[-2:], dtype=torch.bool, device=dev)
        zero[0::4, 0::4] = zero[0::4, 1::4] = True
        zero[1::4, 0::4] = zero[1::4, 1::4] = True
        return torch.where(zero, -0.0, adversarial(*shape))

    def maps(bs, is_, layout):
        cover = torch.randint(-40, 40, (bs, is_, is_), generator=gen,
                              device=dev).clamp(min=-1).to(torch.int32)
        if bs > 1:
            cover[1] = -1
        rgb = plane_maps(bs, 5 if layout == 'strided' else 3, is_, is_)
        if layout == 'strided':
            rgb = rgb[:, 1:4]
        elif layout == 'channel-last':
            rgb = rgb.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        return cover, rgb, plane_maps(bs, is_, is_)

    def compare(name, s, cover, rgb, depth, bg, pool):
        want = plain(s, cover, rgb, depth, bg, pool)
        got = kernel(s, cover, rgb, depth, bg, pool)
        for k, w in want.items():
            if w is None:
                _require(got[k] is None, f'{name}: {k} drawn unasked')
                continue
            _require(got[k].is_contiguous() and _bits_equal(got[k], w),
                     f'{name}: the kernel\'s {k} differs from the plain '
                     f'version in {int((got[k] != w).sum())} of {w.numel()} '
                     f'elements, by up to {float((got[k] - w).abs().max())}')
        return 1

    cases = 0
    for bs, is_ in ((64, 1024), (32, 512), (3, 64), (2, 40), (1, 66),
                    (2, 30)):
        for layout in ('planes', 'strided', 'channel-last'):
            cover, rgb, depth = maps(bs, is_, layout)
            for bg in (adversarial(3), -adversarial(bs, 3).abs()):
                for pool in (True, False):
                    for outs in ('rgb alpha depth', 'rgb', 'alpha',
                                 'depth'):
                        if (bs * is_ * is_ > 2 ** 22
                                and outs not in ('rgb', 'rgb alpha depth')):
                            continue
                        s = RasterizeSettings(
                            image_size=is_, return_rgb='rgb' in outs,
                            return_alpha='alpha' in outs,
                            return_depth='depth' in outs)
                        cases += compare(
                            f'bs {bs} {is_}^2 {layout} bg '
                            f'{tuple(bg.shape)} pool {pool} {outs}', s,
                            cover, rgb, depth, bg, pool)
            del cover, rgb, depth
            torch.cuda.empty_cache()
    _log(f'output pass: the kernel equals its plain version bit for bit '
         f'in {cases} adversarial cases')

    # BASELINE config 5's real maps
    mv = _load_script(os.path.join(ROOT, 'misc', 'torch_multiview.py'))
    args = mv.parse_args([])
    renderer, v, f, tx, eyes = mv.build(args)
    nv, raster = args.views, 2 * args.image_size
    tx = torch.as_tensor(rng.uniform(0, 1, tuple(tx.shape)).astype(
        np.float32), device=dev)
    ms = {}
    with torch.no_grad():
        fc, lit = renderer._lit_faces(v, f, tx)
        for is_, pool in ((raster, True), (args.image_size, False)):
            s = RasterizeSettings(image_size=is_, eps=1e-3)
            m = forward_cuda.forward_shaded(s, fc, lit)
            for bg in (torch.zeros(3, device=dev),
                       torch.rand((nv, 3), generator=gen, device=dev)):
                cases += compare(f'config 5 {is_}^2 pool {pool} bg '
                                 f'{tuple(bg.shape)}', s,
                                 m['face_index_map'], m['rgb'],
                                 m['depth_map'], bg, pool)
            del m
        s = RasterizeSettings(image_size=raster, eps=1e-3)
        m = forward_cuda.forward_shaded(s, fc, lit)
        bg = torch.zeros(3, device=dev)
        call = (s, m['face_index_map'], m['rgb'], m['depth_map'], bg, True)
        kept = kernel(*call)
        lib = _build.library('composite_pool')
        stream = torch.cuda.current_stream(dev).cuda_stream

        def bare():
            lib.nr_composite_pool(
                m['face_index_map'].data_ptr(), m['rgb'].data_ptr(),
                m['depth_map'].data_ptr(), bg.data_ptr(), nv, raster, 1,
                3 * raster * raster, 0, 0, kept['rgb'].data_ptr(),
                kept['alpha'].data_ptr(), kept['depth'].data_ptr(), stream)

        ms['alone'] = _time_ms(bare, reps=50, warmup=3)
        ms['call'] = _time_ms(lambda: kernel(*call), reps=50, warmup=3)
        ms['plain'] = _time_ms(lambda: plain(*call), reps=10, warmup=1)
        ms['alone_again'] = _time_ms(bare, reps=50)
        ms['plain_again'] = _time_ms(lambda: plain(*call), reps=10)
        nbytes = nv * raster * raster * 20 + nv * args.image_size ** 2 * 20
        bound, bound_by = _bound(nbytes, 0)
        del m, kept, call
        torch.cuda.empty_cache()

        # the main path's shape: bs 32, 512^2, rgb only
        s32 = RasterizeSettings(image_size=RASTER, eps=1e-3,
                                return_alpha=False, return_depth=False)
        m32 = forward_cuda.forward_shaded(s32, fc[:BATCH].contiguous(),
                                          lit[:BATCH].contiguous())
        call32 = (s32, m32['face_index_map'], m32['rgb'], None, bg, True)
        cases += compare(f'main shape bs {BATCH} {RASTER}^2 rgb', *call32)
        out32 = kernel(*call32)['rgb']

        def bare32():
            lib.nr_composite_pool(
                m32['face_index_map'].data_ptr(), m32['rgb'].data_ptr(),
                None, bg.data_ptr(), BATCH, RASTER, 1, 3 * RASTER * RASTER,
                0, 0, out32.data_ptr(), None, None, stream)

        ms['main_alone'] = _time_ms(bare32, reps=50, warmup=3)
        ms['main_plain'] = _time_ms(lambda: plain(*call32), reps=10)
        bytes32 = BATCH * RASTER * RASTER * 16 + BATCH * OUT_SIZE ** 2 * 12
        ms['main_bound'] = _bound(bytes32, 0)[0]
        del m32, out32, call32
        torch.cuda.empty_cache()

        renderer.render_rgbad(v, f, tx)
        _reset_launches()
        renderer.render_rgbad(v, f, tx)
        torch.cuda.synchronize()
        launches = _launches()
        waits = {k: n for k, n in tracing.counts().items()
                 if k.startswith('wait.')}
    _require(launches['composite_pool'] == 1
             and launches['forward_shaded'] == 1
             and launches['face_grad'] == 0,
             f'a config-5 call of render_rgbad launched {launches}')
    _log(f'output pass on {smi}: config 5 ({nv} views, {raster}^2 raster '
         f'pooled, rgb + alpha + depth, {nbytes} bytes): kernel alone '
         f'{ms["alone"]:.4f} / {ms["alone_again"]:.4f} ms (bare launches, '
         f'CUDA events), call {ms["call"]:.4f} ms, plain {ms["plain"]:.4f} '
         f'/ {ms["plain_again"]:.4f} ms, bound {bound:.4f} ms ({bound_by}; '
         f'{100 * bound / ms["alone"]:.1f}% of it); main shape (bs {BATCH}, '
         f'{RASTER}^2, rgb): alone {ms["main_alone"]:.4f} ms, plain '
         f'{ms["main_plain"]:.4f} ms, bound {ms["main_bound"]:.4f} ms; '
         f'{cases} cases bit-equal; a config-5 call launches {launches} '
         f'and waits {sum(waits.values())} times: {waits}')
    return dict(ms=ms['call'], plain_ms=ms['plain'], bound_ms=bound,
                bound_by=bound_by, alone_ms=ms['alone'], launches=launches,
                extra=dict(config5_call_waits=waits,main_shape_alone_ms=ms['main_alone'],
                           main_shape_plain_ms=ms['main_plain'],
                           main_shape_bound_ms=ms['main_bound'],
                           cases_bit_equal=cases))



# the face gradient's shapes (phase 23): name -> (bs, nf after fill_back,
# row width, k5, k7_off, leading columns handed over or None for all)
FACE_GRAD_SHAPES = {
    'icosphere bs 128 (K5)': (128, 163840, 12, True, None, None),
    'teapot bs 128 (K5, K6 ts 2)': (128, 4928, 36, True, None, None),
    'teapot bs 32 render_rgbad (K5, K7, K6 ts 2)': (32, 4928, 45, True, 12,
                                                    None),
    'teapot bs 4 render_depth (K7)': (4, 4928, 9, False, 0, None),
    'odd bs 3 x 1,237 (K5, K7, rows 45 apart)': (3, 1237, 45, True, 12, 21),
}


def _face_grad_phase(dev, smi, rng):
    """Phase 23: the face gradient's assembly (``backward_cuda.face_grad``,
    ``csrc/face_reduce.cu``) against its plain version on the card, bit for
    bit as int32 patterns, on per-face random sums (each face's row its own
    draw, about a twelfth of the entries -0, NaN or an infinity), at
    ``FACE_GRAD_SHAPES``: the icosphere cell's step, the teapot cell's
    with its K6 cells, a K7 layout of ``render_rgbad`` and of
    ``render_depth``, and an odd face count whose rows lie further apart
    than the columns handed over.  At the icosphere's and the teapot's
    shapes the kernel is timed alone (CUDA events around bare launches into
    a kept output), as the wrapper's call, against the plain version, the
    chain the port ran before it (zeros, six column sums stacked with
    three zero columns, added) and its byte bound (each face's row of sums
    read once, 36 bytes written).  A teapot training step launches it once,
    a render under no_grad never.  Returns the kernel line's entry: {ms,
    plain_ms, bound_ms, bound_by, alone_ms, launches, extra}."""
    plain, kernel = backward_cuda.face_grad_plain, backward_cuda.face_grad
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))
    lib = _build.library('face_reduce')
    stream = torch.cuda.current_stream(dev).cuda_stream

    def seed_chain(sums, face_shape):
        """the assembly before face_grad: zeros + the stacked K5 slots"""
        cols = []
        for v in range(3):
            for _, c0, c1 in bwd.K5_SLOTS[2 * v:2 * v + 2]:
                cols.append(sums[:, c0] + sums[:, c1])
            cols.append(torch.zeros_like(cols[-1]))
        grad = torch.zeros(face_shape, dtype=torch.float32, device=dev)
        return grad + torch.stack(cols, dim=-1).reshape(face_shape)

    timed, cases = {}, 0
    for name, (bs, nf, width, k5, k7_off, cols) in FACE_GRAD_SHAPES.items():
        n = bs * nf
        full = torch.randn((n, width), generator=gen, device=dev)
        pick = torch.randint(0, 64, (n, width), generator=gen, device=dev,
                             dtype=torch.uint8)
        for k, value in enumerate((-0.0, float('nan'), float('inf'),
                                   -float('inf'), -0.0)):
            full[pick == k] = value
        del pick
        sums = full if cols is None else full[:, :cols]
        face_shape = (bs, nf, 3, 3)
        want = plain(sums, face_shape, k5, k7_off)
        got = kernel(sums, face_shape, k5, k7_off)
        again = kernel(sums, face_shape, k5, k7_off)
        torch.cuda.synchronize()
        gi, wi = got.view(torch.int32), want.view(torch.int32)
        differ = gi != wi
        _require(got.is_contiguous() and not bool(differ.any()),
                 f'face_grad {name}: the kernel differs from the plain '
                 f'version in {int(differ.sum())} of {got.numel()} entries '
                 f'({int((differ & torch.isnan(got) & torch.isnan(want)).sum())}'
                 f' of them NaN on both sides)')
        _require(torch.equal(again.view(torch.int32), gi),
                 f'face_grad {name}: a repeat launch differs')
        cases += 1
        if k5 and k7_off is None and cols is None:
            seed = seed_chain(sums, face_shape)
            _require(torch.equal(seed.view(torch.int32), wi),
                     f'face_grad {name}: the plain version differs from the '
                     f'chain it replaced')
            kept = torch.empty_like(got)

            def bare():
                lib.nr_face_grad(sums.data_ptr(), sums.stride(0), n, 1, -1,
                                 kept.data_ptr(), stream)

            ms = dict(alone=_time_ms(bare, reps=50, warmup=3),
                      call=_time_ms(lambda: kernel(sums, face_shape, k5,
                                                   k7_off), reps=50,
                                    warmup=3),
                      plain=_time_ms(lambda: plain(sums, face_shape, k5,
                                                   k7_off), reps=10),
                      chain=_time_ms(lambda: seed_chain(sums, face_shape),
                                     reps=10),
                      alone_again=_time_ms(bare, reps=50))
            nbytes = n * 12 * 4 + n * 36
            ms['bound'], ms['bound_by'] = _bound(nbytes, 0)
            ms['bytes'] = nbytes
            timed[name] = ms
            del seed, kept
        del full, sums, want, got, again, gi, wi, differ
        torch.cuda.empty_cache()
    for name, ms in timed.items():
        _log(f'face gradient on {smi}, {name}: kernel alone '
             f'{ms["alone"]:.4f} / {ms["alone_again"]:.4f} ms (bare '
             f'launches, CUDA events), call {ms["call"]:.4f} ms, plain '
             f'{ms["plain"]:.4f} ms, the chain it replaced '
             f'{ms["chain"]:.4f} ms, bound {ms["bound"]:.4f} ms '
             f'({ms["bound_by"]}: {ms["bytes"]} bytes; '
             f'{100 * ms["bound"] / ms["alone"]:.1f}% of it)')

    # one training step launches it once, a render without gradient never
    v, f = _teapot()
    vt = torch.as_tensor(v[None], device=dev).expand(4, -1, -1).contiguous()
    ft = torch.as_tensor(f[None].astype(np.int64), device=dev).expand(
        4, -1, -1)
    r = nt.Renderer()
    r.eye = torch.tensor([0.0, 0.5, -2.7], device=dev)
    launches = {}
    for mode in ('step', 'no_grad', 'step'):
        _reset_launches()
        if mode == 'step':
            vg = vt.clone().requires_grad_(True)
            r.render_silhouettes(vg, ft).sum().backward()
        else:
            with torch.no_grad():
                r.render_silhouettes(vt, ft)
        torch.cuda.synchronize()
        launches[mode] = _launches()
    _require(launches['step']['face_grad'] == 1
             and launches['no_grad']['face_grad'] == 0,
             f'face_grad launches: a training step {launches["step"]}, a '
             f'render under no_grad {launches["no_grad"]}')
    _log(f'face gradient: the kernel equals its plain version bit for bit '
         f'in {cases} shapes ({", ".join(FACE_GRAD_SHAPES)}); a training '
         f'step launches it {launches["step"]["face_grad"]} time, a render '
         f'under no_grad {launches["no_grad"]["face_grad"]}')
    main = timed['icosphere bs 128 (K5)']
    teapot = timed['teapot bs 128 (K5, K6 ts 2)']
    return dict(ms=main['call'], plain_ms=main['plain'],
                bound_ms=main['bound'], bound_by=main['bound_by'],
                alone_ms=main['alone'], launches=launches,
                extra=dict(chain_replaced_ms=main['chain'],
                           teapot_alone_ms=teapot['alone'],
                           teapot_plain_ms=teapot['plain'],
                           teapot_chain_replaced_ms=teapot['chain'],
                           teapot_bound_ms=teapot['bound'],
                           shapes_bit_equal=cases))


# the benchmark's cells (phase 24) and the host values each call places
KEPT_CELLS = {'multiview.rgbad_v64': 7, 'teapot.train_b128': 7,
              LARGE_CELL: 4}


@contextlib.contextmanager
def _nothing_kept():
    """``config.place`` with an empty table that keeps nothing: every host
    value is copied, as before values were kept."""
    from neural_renderer_torch.rasterize import config
    size, placed = config._PLACED_KEPT, config._PLACED.copy()
    config._PLACED.clear()
    config._PLACED_KEPT = 0
    try:
        yield
    finally:
        config._PLACED_KEPT = size
        config._PLACED.clear()
        config._PLACED.update(placed)


def _all_bits_equal(a, b):
    """``_bits_equal`` of two images or of two dicts of them, key by key."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k])
                                            for k in a)
    return _bits_equal(a, b)


def _kept_phase(dev, smi, seed):
    """Phase 24: host values kept on the card, in each of ``KEPT_CELLS`` at
    its own shape, driven by the benchmark's ``harness.Program``.  A warmed
    call copies none and finds each kept (``kept.<site>``), and reads the
    binning's pair total once; its images and gradients are bit-equal to
    the same call with nothing kept (``_nothing_kept``); after the light
    direction, a light colour (written in place), the background and the
    angle change, a render is bit-equal to a fresh ``Renderer``'s with
    nothing kept and differs from the one before.  Calls are timed with and
    without keeping, in turns (no claim)."""
    from benchmark import harness
    from neural_renderer_torch.rasterize import config
    bench = harness.load_bench(ROOT)
    for name, sites in KEPT_CELLS.items():
        # each cell from an empty table, as a run of it starts
        config._PLACED.clear()
        _, cfg, mix = harness.load_cell(bench, name, ROOT)
        prog = harness.Program(nt, cfg, mix, seed, dev)
        prog.call(0)                              # warm-up
        torch.cuda.synchronize()
        tracing.reset()
        out, grads = prog.call(1)
        torch.cuda.synchronize()
        counts = tracing.counts()
        copies = {k: n for k, n in counts.items()
                  if k.startswith('wait.copy.')}
        kept = {k: n for k, n in counts.items() if k.startswith('kept.')}
        _require(not copies and sum(kept.values()) == sites
                 and all(n == 1 for n in kept.values())
                 and counts.get('wait.read.bin_total') == 1,
                 f'{name}: a warmed call counts {counts}; want no copy, '
                 f'{sites} host values kept and one read of bin_total')
        with _nothing_kept():
            tracing.reset()
            out0, grads0 = prog.call(1)
            torch.cuda.synchronize()
            copied = sum(n for k, n in tracing.counts().items()
                         if k.startswith('wait.copy.'))
        _require(copied == sites, f'{name}: with nothing kept a call '
                 f'copied {copied} host values; want {sites}')
        _require(_all_bits_equal(out, out0), f'{name}: images differ '
                 'from the same call with nothing kept')
        for g in grads:
            _require(_bits_equal(grads[g], grads0[g]), f'{name}: the '
                     f'gradient of {g} differs with nothing kept')
        del out0, grads0

        def turns(reps=20):
            ms = {True: [], False: []}
            for _ in range(3):
                for keep in (True, False):
                    with contextlib.nullcontext() if keep \
                            else _nothing_kept():
                        prog.synchronize()
                        t0 = time.perf_counter()
                        for i in range(reps):
                            prog.call(i)
                        prog.synchronize()
                    ms[keep].append((time.perf_counter() - t0) * 1e3 / reps)
            return {k: sorted(v)[1] for k, v in ms.items()}

        ms = turns()

        # the same eye, the Renderer's host values changed
        r = prog.renderer
        args = [prog.leaves['vertices'].detach(), prog.faces]
        if mix['entry'] != 'render_silhouettes':
            args.append(prog.leaves['textures'].detach())
        changed = dict(light_direction=[0.3, 0.8, -0.5],
                       background_color=[0.25, 0.5, 0.75],
                       viewing_angle=25)
        with torch.no_grad():
            r.eye = prog.eye(1)
            before = getattr(r, mix['entry'])(*args)
            for key, value in changed.items():
                setattr(r, key, value)
            r.light_color_directional[2] = 0.5
            changed['light_color_directional'] = list(
                r.light_color_directional)
            tracing.reset()
            after = getattr(r, mix['entry'])(*args)
            recopied = sum(n for k, n in tracing.counts().items()
                           if k.startswith('wait.copy.'))
            fresh = nt.Renderer()
            for key in ('image_size', 'anti_aliasing', 'fill_back', 'near',
                        'far', 'rasterizer_eps'):
                setattr(fresh, key, cfg[key])
            for key, value in changed.items():
                setattr(fresh, key, value)
            fresh.eye = r.eye
            with _nothing_kept():
                want = getattr(fresh, mix['entry'])(*args)
            torch.cuda.synchronize()
        # a silhouette's call reads no light, and its background is the
        # rasterizer's default, not the Renderer's: only the angle changed
        resites = 4 if sites == 7 else 1
        _require(recopied == resites, f'{name}: the changed Renderer '
                 f'copied {recopied} host values; want {resites}')
        _require(_all_bits_equal(after, want), f'{name}: a render after '
                 "the Renderer changed differs from a fresh Renderer's")
        _require(not _all_bits_equal(after, before),
                 f'{name}: the changed Renderer renders as before')
        _log(f'kept host values ({name}) on {smi}: a warmed call copies '
             f'none, keeps {kept}, reads bin_total once; images and '
             f'gradients ({sorted(grads)}) bit-equal with nothing kept '
             f'({copied} copies then); after the Renderer changed '
             f'({sorted(changed)}; {recopied} copies) bit-equal to a fresh '
             f"Renderer's; ms a call (median of 3 turns of 20 calls), kept "
             f'{ms[True]:.4f}, nothing kept {ms[False]:.4f} (no claim)')
        del prog, out, grads, before, after, want
        torch.cuda.empty_cache()


# the benchmark's textured cells (phase 25), ts 2 and ts 4 at bs 128
K6_CELLS = ('teapot.train_b128', 'teapot.train_ts4_b128')
# batch elements a slice of the plain reduction takes at bs 128 (its rows
# at ts 4: 204 columns over 16 x 512^2 pixels, 3.4 GB)
K6_PLAIN_SLICE = 16


def _k6_slice(k6, sl):
    """``k6``'s maps for batch elements ``sl``."""
    return k6._replace(z=k6.z[sl], weights=k6.weights[sl],
                       depth_map=k6.depth_map[sl], grad_rgb=k6.grad_rgb[sl])


def _k6_reduce_phase(dev, smi, seed):
    """Phase 25: the K6 factors built inside ``face_reduce``'s tile pass, in
    each of ``K6_CELLS`` at its own shape (bs 128, 512^2 raster, ts 2 and
    ts 4) through the benchmark's ``harness.Program``.  A training step
    reduces once with the factors built from the maps (``k6.in_reduce`` 1,
    ``work.k6_cells`` ``bs * nf' * ts^3``), never builds them in plain torch
    (``texture.texture_cell_factors`` not called), and its vertex and
    texture gradients repeat bit for bit.  On the step's own scene (one
    call's lit faces through the forward kernel), with the gradients of
    ``sum(image)`` and with random ones: the kernel's sums against
    ``face_reduce_plain`` on the card (in slices of ``K6_PLAIN_SLICE``
    batch elements) within ``SUM_TOL``, two runs bit-equal.  The reduction
    timed with and without the factors (CUDA events; each pass alone by the
    profiler) beside its byte bound (``_reduce_work``), and the plain
    torch that built the factors before.  Returns {cell: timings}."""
    from benchmark import harness
    bench = harness.load_bench(ROOT)
    rng = np.random.RandomState(seed % 2 ** 32)
    out = {}
    for name in K6_CELLS:
        _, cfg, mix = harness.load_cell(bench, name, ROOT)
        prog = harness.Program(nt, cfg, mix, seed, dev)
        ts, bs = cfg['texture_size'], mix['batch']
        nfp = prog.faces.shape[1] * (2 if cfg['fill_back'] else 1)
        prog.call(0)                              # warm-up
        torch.cuda.synchronize()
        built, plain_factors = [], tex.texture_cell_factors

        def counted(*args):
            built.append(1)
            return plain_factors(*args)

        tex.texture_cell_factors = counted
        try:
            steps = []
            for _ in range(2):
                tracing.reset()
                steps.append(prog.call(1)[1])
                torch.cuda.synchronize()
                counts = tracing.counts()
        finally:
            tex.texture_cell_factors = plain_factors
        _require(counts.get('k6.in_reduce') == 1
                 and counts.get('launch.face_reduce') == 1
                 and counts.get('work.k6_cells') == bs * nfp * ts ** 3
                 and not built,
                 f'{name}: a training step counts {counts} and built the '
                 f'factors in plain torch {len(built)} times; want one '
                 'reduction that builds them')
        for g in steps[0]:
            _require(_bits_equal(steps[0][g], steps[1][g]),
                     f'{name}: the gradient of {g} differs between two '
                     'steps of one call')
        with _profile() as prof:
            for i in range(4):
                prog.call(i)
        split = _span_split(prof, 4)
        del prof
        _log(f'{name} on {smi}: {split["device_ms"]:.3f} ms of device time '
             f'a step in {split["ops"]:.1f} operations; by span '
             + json.dumps({k: round(x, 3)
                           for k, x in split['by_span'].items()}))

        # the reduction on the step's scene
        raster = cfg['image_size'] * (2 if cfg['anti_aliasing'] else 1)
        s = RasterizeSettings(image_size=raster, near=float(cfg['near']),
                              far=float(cfg['far']),
                              eps=float(cfg['rasterizer_eps']),
                              return_alpha=False, return_depth=False)
        r = prog.renderer
        r.eye = prog.eye(1)
        with torch.no_grad():
            fc, tx = r._lit_faces(prog.vertices, prog.faces, prog.textures)
            rgb, _, _, maps = core._forward_all(s, fc, tx, torch.zeros(
                3, device=dev))
        maps['rgb'] = rgb
        fim, bins = maps['face_index_map'], maps['bins']
        g_rand = torch.as_tensor(rng.normal(0, 1, (bs, raster, raster, 3))
                                 .astype(np.float32), device=dev)
        errs = {}
        for kind, g_rgb in (('sum(image)', _sum_image_grads(
                bs, raster, dev)['g_rgb']), ('random', g_rand)):
            grads = dict(g_rgb=g_rgb, g_alpha=None, g_depth=None)
            stack, k6 = _channel_stack(s, maps, grads, nfp, ts)
            got = backward_cuda.face_reduce(stack, fim, nfp, k6, bins)
            again = backward_cuda.face_reduce(stack, fim, nfp, k6, bins)
            want = torch.cat([backward_cuda.face_reduce_plain(
                stack[b:b + K6_PLAIN_SLICE], fim[b:b + K6_PLAIN_SLICE], nfp,
                _k6_slice(k6, slice(b, b + K6_PLAIN_SLICE)))
                for b in range(0, bs, K6_PLAIN_SLICE)])
            torch.cuda.synchronize()
            _require(_bits_equal(got, again), f'{name} ({kind}): two '
                     'reductions differ')
            errs[kind] = _sum_check(f'{name} face_reduce ({kind})', got,
                                    want, 1)
            del got, again, want
        del g_rand

        def with_k6():
            return backward_cuda.face_reduce(stack, fim, nfp, k6, bins)

        def without_k6():
            return backward_cuda.face_reduce(stack, fim, nfp, None, bins)

        ms = dict(with_k6=_time_ms(with_k6, reps=20, warmup=2),
                  without_k6=_time_ms(without_k6, reps=20, warmup=2),
                  factors_plain=_time_ms(lambda: k6.factors(fim), reps=5))
        ms['with_k6_again'] = _time_ms(with_k6, reps=20)
        ms['without_k6_again'] = _time_ms(without_k6, reps=20)
        for key, fn in (('with_k6', with_k6), ('without_k6', without_k6)):
            ms[key + '_tile_alone'] = _kernel_device_ms(fn, 5,
                                                        'face_reduce_tile')
            ms[key + '_face_alone'] = _kernel_device_ms(fn, 5,
                                                        'face_reduce_face')
        cov = int((fim >= 0).sum())
        for key, t in (('with_k6', ts), ('without_k6', 0)):
            ms[key + '_bound'], _ = _bound(*_reduce_work(
                bs * raster * raster, cov, stack.shape[1], t, bs * nfp))
        ms['covered'] = cov
        ms['max_abs_err'] = {k: e for k, (e, _) in errs.items()}
        ms['by_span'] = split['by_span']
        out[name] = ms
        _log(f'K6 in the reduction ({name}, bs {bs}, {raster}^2, ts {ts}) '
             f'on {smi}: a step reduces once with the factors from the maps '
             f"(k6.in_reduce {counts.get('k6.in_reduce')}, work.k6_cells "
             f"{counts.get('work.k6_cells')}), builds none in plain torch, "
             f'and repeats its gradients bit for bit; against '
             f'face_reduce_plain '
             + ', '.join(f'{k} max abs err {e:.3g} ({q:.3g} x column max)'
                         for k, (e, q) in errs.items())
             + f', repeat runs bit-equal; {cov} covered pixels; reduction '
             f'with the factors {ms["with_k6"]:.4f} / '
             f'{ms["with_k6_again"]:.4f} ms (tile pass alone '
             f'{_fmt_ms(ms["with_k6_tile_alone"])}, face pass '
             f'{_fmt_ms(ms["with_k6_face_alone"])}), bound '
             f'{ms["with_k6_bound"]:.4f} ms; without '
             f'{ms["without_k6"]:.4f} / {ms["without_k6_again"]:.4f} ms '
             f'(tile pass {_fmt_ms(ms["without_k6_tile_alone"])}, face pass '
             f'{_fmt_ms(ms["without_k6_face_alone"])}), bound '
             f'{ms["without_k6_bound"]:.4f} ms; the factors in plain torch '
             f'{ms["factors_plain"]:.3f} ms')
        del prog, steps, maps, stack, k6, fim, bins, fc, tx, rgb
        torch.cuda.empty_cache()
    return out


# the benchmark's cell of cubes above ts 4 (phase 26), ts 16 at bs 32
TS16_CELL = 'teapot.train_ts16_b32'
# the elements of a ts-16 step that phase 26 holds to the plain scatter
TS16_CHECKED = 2


def _span_split(prof, steps):
    """Device ms a step of a profile of ``steps`` steps by innermost
    ``nr.*`` span of the launch (the runtime call sharing the operation's
    correlation id, on the span's thread; '(none)' outside every span) and
    by operation (``_op_name``), and the device operations a step.  A span
    is the program's whatever its category in the trace: ``cpu_op`` (the
    port's fast records) or ``user_annotation`` (``record_function``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    spans, runtime, device = {}, {}, []
    for ev in events:
        cat = ev.get('cat', '')
        if ev.get('ph') != 'X':
            continue
        if cat in ('cpu_op', 'user_annotation') and ev['name'].startswith(
                tracing.PREFIX):
            spans.setdefault(ev['tid'], []).append(
                (ev['ts'], ev['ts'] + ev['dur'], ev['name']))
        elif cat in ('cuda_runtime', 'cuda_driver'):
            corr = ev.get('args', {}).get('correlation')
            if corr is not None:
                runtime[corr] = (ev['ts'], ev['tid'])
        elif cat in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            device.append(ev)
    by_span, by_op = {}, {}
    for ev in device:
        ms = ev['dur'] / 1e3 / steps
        key = _op_name(ev['name'])
        by_op[key] = by_op.get(key, 0.0) + ms
        at = runtime.get(ev.get('args', {}).get('correlation'))
        span = '(none)'
        if at is not None:
            inner = [sp for sp in spans.get(at[1], ())
                     if sp[0] <= at[0] <= sp[1]]
            if inner:
                span = min(inner, key=lambda sp: sp[1] - sp[0])[2]
        by_span[span] = by_span.get(span, 0.0) + ms

    def order(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return dict(device_ms=sum(by_op.values()), ops=len(device) / steps,
                by_span=order(by_span), by_op=order(by_op))


@contextlib.contextmanager
def _nan_empty():
    """``torch.empty`` handing out float tensors filled with NaN (others
    with -1), so that a kernel that leaves an element of its output
    unwritten shows it."""
    plain = torch.empty

    def empty(*args, **kwargs):
        t = plain(*args, **kwargs)
        return t.fill_(float('nan') if t.is_floating_point() else -1)

    torch.empty = empty
    try:
        yield
    finally:
        torch.empty = plain


def _column_err(got, want, chunk=1 << 24):
    """(largest |got - want| per column, largest |want| per column) of two
    ``[..., 3]`` CPU tensors, in chunks of rows."""
    got, want = got.reshape(-1, 3), want.reshape(-1, 3)
    err = torch.zeros(3)
    scale = torch.zeros(3)
    for i in range(0, want.shape[0], chunk):
        w = want[i:i + chunk]
        err = torch.maximum(err, (got[i:i + chunk] - w).abs().amax(0))
        scale = torch.maximum(scale, w.abs().amax(0))
    return err, scale


def _tex_scatter_check(name, s, tex_maps, shape, bins, lighting=()):
    """The texture scatter (``texture.grad_textures`` on the card) on one
    raster's maps ``tex_maps`` (face-index map, z, weights, depth and the
    rgb gradient, as the backward hands them over) for cubes ``shape``,
    lit, or with ``lighting`` (the unlit cubes and their per-face light)
    folded: repeat runs bitwise equal; a launch into NaN-filled memory
    leaves no NaN and gives the same bits (every cell written); the faces
    that won no pixel all zeros; against ``texture.grad_textures_plain`` on
    CPU copies within ``SEGMENT_TOL`` x the column's max, the light's
    gradient within ``LIGHT_TOL`` x its max.  Returns dict(max_abs_err,
    faces, faces_won), with a light also light_err and light_max."""
    def run():
        out = tex.grad_textures(s, *tex_maps, shape, bins, *lighting)
        return out if lighting else (out,)

    got = run()
    again = run()
    with _nan_empty():
        nan = run()
    torch.cuda.synchronize()
    _require(all(_bits_equal(a, b) for a, b in zip(got, again)),
             f'texture scatter {name}: a repeat run differs')
    _require(not any(bool(torch.isnan(x).any()) for x in nan)
             and all(_bits_equal(a, b) for a, b in zip(got, nan)),
             f'texture scatter {name}: a launch into NaN-filled memory '
             'left cells unwritten or differs')
    del again, nan
    fim = tex_maps[0]
    won = torch.zeros(shape[:2], dtype=torch.bool, device=fim.device)
    b = torch.arange(shape[0], device=fim.device)[:, None, None].expand(
        fim.shape)
    won[b[fim >= 0], fim[fim >= 0].long()] = True
    _require(all(bool((x[~won] == 0).all()) for x in got),
             f'texture scatter {name}: a face that won no pixel has a '
             'non-zero cell')
    got = [x.cpu() for x in got]
    want = tex.grad_textures_plain(s, *(x.cpu() for x in tex_maps), shape,
                                   *(x.cpu() for x in lighting))
    want = want if lighting else (want,)
    err, scale = _column_err(got[0], want[0])
    _require(float(scale.min()) > 0 and bool((err <= SEGMENT_TOL * scale)
                                             .all()),
             f'texture scatter {name}: differs from the plain version by '
             f'{err.tolist()} (column max {scale.tolist()})')
    out = dict(max_abs_err=float(err.max()), faces=won.numel(),
               faces_won=int(won.sum()))
    if lighting:
        out.update(light_err=float((got[1] - want[1]).abs().max()),
                   light_max=float(want[1].abs().max()))
        _require(out['light_max'] > 0
                 and out['light_err'] <= LIGHT_TOL * out['light_max'],
                 f'texture scatter {name}: the light\'s gradient differs '
                 f'from the plain version by {out["light_err"]} (max '
                 f'{out["light_max"]})')
    return out


def _tex_scatter_timing(s, tex_maps, shape, bins, lighting):
    """The texture scatter at one shape: a call (CUDA events), its three
    kernels alone (the profiler), with lit cubes and (``folded_*``) with
    ``lighting``, the unlit cubes and their light, a memset of the cube
    (``torch.zeros``, the floor of its writes), its bound (bytes: the rgb
    gradient, z, weights and depth of each covered pixel, the face-index
    map, the cube written once; ``tex_scatter_roofline.ts16``'s count), the
    plain version on the card (``corner_rows`` and one ``index_add_``),
    that ``index_add_`` alone (the library call) and the route the kernel
    replaced (the rows sorted by cell, ``segments.sort_segments``, and
    summed in order, ``segments.segment_sum``).  Dict of ms."""
    def kern():
        return tex.grad_textures(s, *tex_maps, shape, bins)

    def folded():
        return tex.grad_textures(s, *tex_maps, shape, bins, *lighting)

    nseg = int(np.prod(shape[:-1]))
    covered = int((tex_maps[0] >= 0).sum())
    is_ = tex_maps[0].shape[1]
    out = dict(ms=_time_ms(kern, reps=10),
               alone_ms=_kernel_device_ms(kern, 5, 'tex_scatter'),
               zero_kernel_ms=_kernel_device_ms(kern, 5,
                                                'tex_scatter_zero_kernel'),
               rows_kernel_ms=_kernel_device_ms(kern, 5,
                                                'tex_scatter_rows_kernel'),
               main_kernel_ms=_kernel_device_ms(kern, 5, 'tex_scatter_kernel'),
               folded_ms=_time_ms(folded, reps=10),
               folded_alone_ms=_kernel_device_ms(folded, 5, 'tex_scatter'),
               folded_main_kernel_ms=_kernel_device_ms(
                   folded, 5, 'tex_scatter_kernel'),
               memset_ms=_time_ms(lambda: torch.zeros(
                   shape, device=tex_maps[0].device), reps=10))
    out['bound_ms'], out['bound_by'] = _bound(
        40 * covered + 4 * shape[0] * is_ * is_ + 12 * nseg, 64 * covered)
    out['plain_ms'] = _time_ms(lambda: tex.grad_textures_plain(
        s, *tex_maps, shape), reps=3)
    ids, rows = tex.corner_rows(s, *tex_maps, shape, nseg)
    out['library_ms'] = _time_ms(lambda: torch.zeros(
        (nseg + 1, 3), device=rows.device).index_add_(0, ids, rows), reps=3)

    def sort_route():
        perm, offsets = segments.sort_segments(ids, nseg)
        return segments.segment_sum(rows, perm, offsets)

    out['sort_route_ms'] = _time_ms(sort_route, reps=3)
    del ids, rows
    torch.cuda.empty_cache()
    out.update(covered=covered, cells=nseg)
    return out


def _ts16_phase(dev, smi, seed):
    """Phase 26: the path of cubes above ts 4 in ``TS16_CELL`` at its own
    shape (bs 32, 512^2 raster, ts 16) through the benchmark's
    ``harness.Program``: the cubes unlit with their per-face light, K4
    sampled in plain torch with the light, the texture and light gradients
    by the texture scatter (``csrc/tex_scatter.cu``).  A training step
    folds the light (``light.folded`` 1), launches the scatter once
    (``launch.tex_scatter`` and ``k6.scatter`` 1, ``work.k6_scatter_cells``
    ``bs nf' ts^3``, no rows handed to a sort), reduces no K6 factors, sums
    its vertex gradient by segments (one launch) and repeats its gradients
    bit for bit.  For ``TS16_CHECKED`` elements drawn from the seed, the
    image bit-equal to the lit-cube route's (``_lit_faces``, then
    ``rasterize`` without a light), and the step's texture gradient against
    ``texture.grad_textures_plain`` with the light on CPU copies of their
    maps, carried back through fill_back on the CPU, within
    ``SEGMENT_TOL`` x the column's max, the light's gradient within
    ``LIGHT_TOL`` and, against the lit-cube route's (autograd of the lit
    cube back from the plain scatter without a light), within
    ``LIGHT_ROUTE_TOL``.  The kernel on the maps of all bs elements with a random
    rgb gradient, lit and with the scene's light, at ts 16 and ts 8, and on
    one element at ts 32 (a cube of 384 KB, more than an SM's shared
    memory), by ``_tex_scatter_check``, and timed at ts 16
    (``_tex_scatter_timing``).  The step's peak memory, its time and its
    device time by innermost ``nr.*`` span and by operation.  Returns a
    dict of the numbers."""
    from benchmark import harness
    bench = harness.load_bench(ROOT)
    _, cfg, mix = harness.load_cell(bench, TS16_CELL, ROOT)
    prog = harness.Program(nt, cfg, mix, seed, dev)
    ts, bs = cfg['texture_size'], mix['batch']
    nf = prog.faces.shape[1]
    nfp = nf * (2 if cfg['fill_back'] else 1)
    raster = cfg['image_size'] * (2 if cfg['anti_aliasing'] else 1)
    prog.call(0)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    steps = []
    for _ in range(2):
        tracing.reset()
        steps.append(prog.call(1)[1])
        torch.cuda.synchronize()
        counts = tracing.counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want_counts = {'light.folded': 1, 'launch.tex_scatter': 1,
                   'k6.scatter': 1,
                   'work.k6_scatter_cells': bs * nfp * ts ** 3}
    _require(all(counts.get(k) == v for k, v in want_counts.items())
             and 'work.k6_scatter_rows' not in counts
             and 'k6.in_reduce' not in counts
             and counts.get('launch.segment_sum') == 1
             and counts.get('launch.face_reduce') == 1,
             f'{TS16_CELL}: a training step counts {counts}; want '
             f'{want_counts}, no rows to a sort, no k6.in_reduce, one '
             'face_reduce and one segment_sum launch')
    for g in steps[0]:
        _require(_bits_equal(steps[0][g], steps[1][g]),
                 f'{TS16_CELL}: the gradient of {g} differs between two '
                 'steps of one call')
    got_tex = steps[0]['textures']
    del steps

    # two elements' texture gradient on the CPU from the card's maps
    rng = np.random.RandomState(seed % 2 ** 32)
    idx = sorted(rng.choice(bs, TS16_CHECKED, replace=False).tolist())
    at = torch.tensor(idx, device=dev)
    s = RasterizeSettings(image_size=raster, near=float(cfg['near']),
                          far=float(cfg['far']),
                          eps=float(cfg['rasterizer_eps']),
                          return_alpha=False, return_depth=False)
    r = prog.renderer
    r.eye = prog.eye(1)
    v, f, t = (x.index_select(0, at) for x in (
        prog.vertices, prog.faces, prog.textures))
    # the image, folded and by the lit-cube route, as a training step
    # draws it (a gradient can flow)
    t_req = t.clone().requires_grad_(True)
    folded_img = r.render(v, f, t_req).detach()
    fc, lit = r._lit_faces(v, f, t_req)
    lit_img = nt.rasterize(fc, lit, r.image_size, r.anti_aliasing, r.near,
                           r.far, r.rasterizer_eps,
                           r.background_color).detach()
    _require(_bits_equal(folded_img, lit_img), f'{TS16_CELL}: the image '
             'with the light folded differs from the lit-cube route\'s')
    del t_req, folded_img, fc, lit, lit_img
    with torch.no_grad():
        fc, tx, light = r._shaded_faces(v, f, t)
        _, _, _, maps = core._forward_all(s, fc, tx,
                                          torch.zeros(3, device=dev), light)
    g_rgb = _sum_image_grads(TS16_CHECKED, raster, dev)['g_rgb']
    tex_maps = [maps['face_index_map'], maps['z'].permute(0, 2, 3, 1),
                maps['weights'].permute(0, 2, 3, 1), maps['depth_map'],
                g_rgb]
    card_tex, card_light = tex.grad_textures(
        s, *tex_maps, tuple(tx.shape), maps['bins'], tx, light)
    cpu_maps = [x.cpu() for x in tex_maps]
    cpu_tex, cpu_light = tex.grad_textures_plain(
        s, *cpu_maps, tuple(tx.shape), tx.cpu(), light.cpu())
    # the lit-cube route's light gradient: autograd of the lit cube back
    # from the plain scatter of lit cubes
    light_req = light.cpu().requires_grad_(True)
    route_light, = torch.autograd.grad(
        light_cubes(tx.cpu(), light_req), light_req,
        tex.grad_textures_plain(s, *cpu_maps, tuple(tx.shape)))
    del fc, tx, light, maps, tex_maps, cpu_maps, light_req
    errs = {}

    def band(name, got, want):
        err, scale = _column_err(got.cpu(), want)
        _require(float(scale.min()) > 0
                 and bool((err <= SEGMENT_TOL * scale).all()),
                 f'{TS16_CELL}: {name} differs from the plain version by '
                 f'{err.tolist()} (column max {scale.tolist()})')
        errs[name] = float(err.max())

    band('the raster\'s texture gradient', card_tex, cpu_tex)
    light_err = float((card_light.cpu() - cpu_light).abs().max())
    _require(light_err <= LIGHT_TOL * float(cpu_light.abs().max()),
             f'{TS16_CELL}: the light\'s gradient differs from the plain '
             f'version by {light_err} (max {float(cpu_light.abs().max())})')
    errs['the light\'s gradient'] = light_err
    route_err = float((card_light.cpu() - route_light).abs().max())
    route_max = float(route_light.abs().max())
    _require(route_err <= LIGHT_ROUTE_TOL * route_max,
             f'{TS16_CELL}: the light\'s gradient differs from the lit-cube '
             f'route\'s by {route_err} (max {route_max})')
    errs['the light\'s gradient against the lit-cube route'] = route_err
    del card_tex, card_light, cpu_light, route_light
    t_cpu = t.cpu().requires_grad_(True)
    filled = (nt.Renderer._fill_back_textures(t_cpu) if cfg['fill_back']
              else t_cpu)
    want_tex, = torch.autograd.grad(filled, t_cpu, cpu_tex)
    band('the step\'s texture gradient', got_tex.index_select(0, at),
         want_tex)
    del got_tex, filled, cpu_tex, want_tex, t_cpu, v, f, t

    # the kernel on all bs elements' maps, a random rgb gradient, lit and
    # with the scene's light: ts 16 (the cell's), ts 8, and ts 32 on one
    # element, the unlit cubes of the two others drawn from the seed
    with torch.no_grad():
        fc, tx16, light = r._shaded_faces(prog.vertices, prog.faces,
                                          prog.textures)
        _, _, _, maps = core._forward_all(s, fc, tx16,
                                          torch.zeros(3, device=dev), light)
    shape16 = tuple(tx16.shape)
    gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
    g_rgb = torch.randn((bs, raster, raster, 3), device=dev, generator=gen)
    tex_maps = [maps['face_index_map'], maps['z'].permute(0, 2, 3, 1),
                maps['weights'].permute(0, 2, 3, 1), maps['depth_map'],
                g_rgb]
    bins = maps['bins']
    scatter = {}
    for ts_k, bs_k in ((ts, bs), (8, bs), (32, 1)):
        name = f'ts {ts_k}, bs {bs_k}'
        if bs_k == bs:
            maps_k, bins_k = tex_maps, bins
        else:
            with torch.no_grad():
                _, _, _, one = core._forward_all(
                    s, fc[:1], tx16[:1], torch.zeros(3, device=dev),
                    light[:1])
            maps_k = [one['face_index_map'], one['z'].permute(0, 2, 3, 1),
                      one['weights'].permute(0, 2, 3, 1), one['depth_map'],
                      g_rgb[:1]]
            bins_k = one['bins']
        shape_k = (bs_k, nfp, ts_k, ts_k, ts_k, 3)
        scatter[name] = _tex_scatter_check(f'{TS16_CELL} {name}', s, maps_k,
                                           shape_k, bins_k)
        unlit = tx16 if ts_k == ts else torch.rand(
            shape_k, device=dev, generator=gen)
        scatter[name + ', light'] = _tex_scatter_check(
            f'{TS16_CELL} {name}, light', s, maps_k, shape_k, bins_k,
            (unlit, light[:bs_k]))
        del unlit
        torch.cuda.empty_cache()
    timing = _tex_scatter_timing(s, tex_maps, shape16, bins, (tx16, light))
    del fc, tx16, light, maps, tex_maps, bins, g_rgb
    torch.cuda.empty_cache()
    _log(f'texture scatter on {smi}: repeat runs bitwise equal, every cell '
         f'written (a launch into NaN-filled memory), faces without a pixel '
         f'all zeros, against the plain version on the CPU ({SEGMENT_TOL} x '
         'column max): ' + '; '.join(
             f'{k}: max abs err {c["max_abs_err"]:.3g}'
             + (f', the light\'s {c["light_err"]:.3g} of max '
                f'{c["light_max"]:.3g}' if 'light_err' in c else '')
             + f', {c["faces"] - c["faces_won"]} of {c["faces"]} faces '
             'without a pixel' for k, c in scatter.items())
         + f'; at ts {ts}, bs {bs} ({timing["covered"]} covered pixels, '
         f'{timing["cells"]} cells): a call {timing["ms"]:.3f} ms, alone '
         f'{_fmt_ms(timing["alone_ms"])} (tex_scatter_zero_kernel '
         f'{_fmt_ms(timing["zero_kernel_ms"])}, tex_scatter_rows_kernel '
         f'{_fmt_ms(timing["rows_kernel_ms"])}, tex_scatter_kernel '
         f'{_fmt_ms(timing["main_kernel_ms"])}); with the light a call '
         f'{timing["folded_ms"]:.3f} ms, alone '
         f'{_fmt_ms(timing["folded_alone_ms"])} (tex_scatter_kernel '
         f'{_fmt_ms(timing["folded_main_kernel_ms"])}); a memset of the cube '
         f'{timing["memset_ms"]:.3f} ms, bound '
         f'{timing["bound_ms"]:.4f} ms by {timing["bound_by"]}; plain on the '
         f'card {timing["plain_ms"]:.3f} ms (its index_add_ '
         f'{timing["library_ms"]:.3f} ms), the sort route it replaced '
         f'(corner rows sorted by cell, segment_sum) '
         f'{timing["sort_route_ms"]:.3f} ms')

    # the step timed, then profiled
    step_ms = _time_ms(lambda: prog.call(2), reps=8, warmup=1)
    with _profile() as prof:
        for i in range(4):
            prog.call(i)
    split = _span_split(prof, 4)
    del prof
    out = dict(counts={k: counts[k] for k in want_counts}, peak_bytes=peak,
               resident_bytes=base, step_ms=step_ms,
               images_per_s=bs * 1e3 / step_ms, max_abs_err=errs,
               checked=idx, scatter=scatter, timing=timing, **split)
    _log(f'ts > 4 path ({TS16_CELL}, bs {bs}, {raster}^2, ts {ts}) on {smi}:'
         f' a step folds the light and launches the texture scatter once '
         f'({out["counts"]}), one segment_sum launch, no K6 in the '
         f'reduction, gradients bit-equal on a repeat; elements {idx}: the '
         'image bit-equal to the lit-cube route\'s, against the plain '
         'index_add_ on the CPU ' + ', '.join(f'{k} max abs err {e:.3g}'
                                              for k, e in errs.items())
         + f' ({SEGMENT_TOL} x column max); peak {peak} bytes '
         f'({peak / 2 ** 30:.3f} GiB; {base} resident before the step); '
         f'{step_ms:.3f} ms a step ({out["images_per_s"]:.1f} images/s), '
         f'{split["device_ms"]:.3f} ms of device time in '
         f'{split["ops"]:.1f} operations; by span '
         + json.dumps({k: round(x, 3) for k, x in split['by_span'].items()})
         + '; by operation ' + json.dumps(
             {k: round(x, 3) for k, x in list(split['by_op'].items())[:16]}))
    del prog
    torch.cuda.empty_cache()
    return out


# entries of a span that phase 27 times under each record
SPAN_PROBES = 20000


def _span_cost_us(record, n=SPAN_PROBES):
    """Host us a span costs: ``n`` entries and exits of ``record(name)``,
    timed in turns with the others, the least of three rounds."""
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            with record('nr.probe'):
                pass
        us = (time.perf_counter() - t0) * 1e6 / n
        best = us if best is None else min(best, us)
    return best


def _tracing_phase(dev, smi, seed):
    """Phase 27: what the port's tracing costs on the card's host.  The us
    a span costs while a profiler of the host and the card runs, entered
    as ``torch.profiler.record_function`` (the spans before) and as the
    profiler's fast record (``tracing.span``'s), and ``tracing.span`` with
    no profiler.  Then in each benchmark cell, through ``harness.Program``
    at the cell's own shape: ms a call of ``trace_calls`` untraced calls,
    of the harness's device-only traced stretch and of its host traced
    stretch (``harness._profiled``, both from a synchronized start to the
    synchronize that ends them), in two rounds; the device-only stretch's
    idle share (``trace.idle_pct``, what ``device_idle_pct.*`` reads) and
    the host stretch's device ms a call by innermost span
    (``_span_split``).  Returns {'span_us': ..., cell: ...}."""
    from benchmark import harness, trace
    from torch._C._profiler import _RecordFunctionFast
    cost = {}
    with _profile():
        for rnd in ('', '_again'):
            cost['record_function' + rnd] = _span_cost_us(
                torch.profiler.record_function)
            cost['fast' + rnd] = _span_cost_us(_RecordFunctionFast)
    cost['off'] = _span_cost_us(lambda name: tracing.span('probe'))
    out = dict(span_us=cost)
    _log(f'a span on the host of {smi}, us while a profiler runs: '
         f'record_function {cost["record_function"]:.3f} / '
         f'{cost["record_function_again"]:.3f}, fast record '
         f'{cost["fast"]:.3f} / {cost["fast_again"]:.3f}; tracing.span with '
         f'no profiler {cost["off"]:.4f}')
    bench = harness.load_bench(ROOT)
    for cell in [w['name'] for w in bench['workloads']]:
        _, cfg, mix = harness.load_cell(bench, cell, ROOT)
        prog = harness.Program(nt, cfg, mix, seed, dev)
        n = mix['trace_calls']
        for i in range(mix['warmup_calls']):
            prog.call(i)
        prog.synchronize()
        ms = dict(untraced=[], device_stretch=[], host_stretch=[])
        for _ in range(2):
            t0 = time.perf_counter()
            for i in range(n):
                prog.call(i)
            prog.synchronize()
            ms['untraced'].append((time.perf_counter() - t0) * 1e3 / n)
            dev_prof, dev_s = harness._profiled(prog, 0, n, False)
            ms['device_stretch'].append(dev_s * 1e3 / n)
            host_prof, host_s = harness._profiled(prog, 0, n, True)
            ms['host_stretch'].append(host_s * 1e3 / n)
        rec = trace.record(dev_prof, host_prof, n, dev_s)
        split = _span_split(host_prof, n)
        out[cell] = dict(ms=ms, device_idle_pct=trace.idle_pct(rec),
                         device_ms=split['device_ms'],
                         by_span=split['by_span'])
        _log(f'tracing in {cell} on {smi}: ms a call untraced '
             f'{ms["untraced"]}, device-only stretch '
             f'{ms["device_stretch"]}, host stretch {ms["host_stretch"]}; '
             f'device-only idle {out[cell]["device_idle_pct"]}%; host '
             f'stretch {split["device_ms"]:.3f} device ms a call, by span '
             + json.dumps({k: round(x, 4)
                           for k, x in split['by_span'].items()}))
        del prog, dev_prof, host_prof, rec
        torch.cuda.empty_cache()
    return out


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
    built = _build.build_all(_build.LIBRARIES)
    for name in _build.LIBRARIES:
        _build.library(name)
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
    # the binning at the edges of its 128-face chunks, a NaN face in row 0
    edge_rng = np.random.RandomState(args.seed + 1)
    for nf_edge in (1, 31, 129, 300):
        fc = edge_rng.uniform(-0.9, 0.9, (3, nf_edge, 3, 3)).astype(
            np.float32)
        fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
        fc[0, 0, 1, 0] = np.nan
        _compare_bins(f'random 64^2 bs 3 nf {nf_edge}, a NaN face',
                      RasterizeSettings(image_size=64, eps=1e-3),
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
    tile = _build.library('forward_shaded').nr_forward_shaded_tile()
    pairs32 = _binned_pairs(s512, fc32, tile)
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
    tile_pairs32 = _compare_bins(
        f'teapot {RASTER}^2 bs {BATCH} (main path shape)', s512, fc32)

    # the benchmark's count (binning_roofline.sil): faces read, records,
    # an id per pair of each face's tile box and a start per tile written
    bin_work = _binning_metric().binning_work(fc32, RASTER)
    bin_bound = _bound(bin_work['bytes'], bin_work['ops'])
    binning_times = _binning_times(
        f'at bs {BATCH}, {RASTER}^2, nf {nf2}', s512, fc32, tile, smi)
    binning_times.update(bound_ms=bin_bound[0], bound_by=bin_bound[1],
                         pairs=tile_pairs32)
    _log(f'setup + binning bound at bs {BATCH}: {bin_bound[0]:.4f} ms by '
         f'{bin_bound[1]} ({bin_work["pairs"]} pairs counted, '
         f'{tile_pairs32} in the padded boxes)')

    # the real model's 24 views as misc/torch_render.py renders them (a
    # face over 252 tiles, lists of up to 944 faces): lists equal, timed
    tr = _load_script(os.path.join(ROOT, 'misc', 'torch_render.py'))
    vm, fm, tm = tr.load_mesh(MODEL, 2, dev)
    views = nt.Renderer()
    views.image_size = OUT_SIZE
    views.eye = tr.view_eyes(24, DISTANCE, ELEVATION, dev)
    fc24, _ = views._lit_faces(vm.expand(24, -1, -1), fm.expand(24, -1, -1),
                               tm.expand((24,) + tm.shape[1:]))
    _compare_bins(f'model {RASTER}^2 24 views', s512, fc24)
    binning_times['model_24_views'] = _binning_times(
        f'of the model at 24 views, {RASTER}^2, nf {fc24.shape[1]}', s512,
        fc24, tile, smi)
    del vm, fm, tm, fc24

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
             f'stack channels and the K6 maps) on {smi}: {name} {k1:.3f} / '
             f'{k2:.3f} ms, '
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
    bounds['face_reduce'] = _bound(*_reduce_work(pixels32, cov, channels,
                                                 k6.ts, BATCH * nf2))
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
    # channel-leading stack, the K6 maps and the face map): the K6 factors
    # built and expanded to their cell columns, the covered pixels' rows
    # gathered pixel-major, then one index_add_ into per-face rows.  No
    # single PyTorch call computes the function; index_add_ is its library
    # core, timed alone on rows gathered beforehand as well
    def library_reduce():
        covered = (fim >= 0).reshape(-1)
        seg = bwd.face_segments(fim, nf2).reshape(-1)[covered]
        full = torch.cat([stack, tex.texture_channels_cells(
            k6.factors(fim), k6.ts)], dim=1)
        rows = full.permute(0, 2, 3, 1).reshape(-1, cols)[covered]
        sums = torch.zeros((BATCH * nf2, cols), device=dev)
        return sums.index_add_(0, seg, rows), seg, rows

    sums, seg, rows = library_reduce()
    err, _ = _sum_check('face_reduce library side', sums, reduced, 1)
    library['face_reduce'] = _time_ms(library_reduce, reps=20, warmup=2)
    add_ms = _time_ms(lambda: sums.index_add_(0, seg, rows), reps=20,
                      warmup=2)
    _log(f'library side of face_reduce from its inputs (K6 factors and '
         f'expansion, '
         f'gather of the {cov} covered pixel rows x {cols} columns, '
         f'index_add_) {library["face_reduce"]:.3f} ms, of which '
         f'index_add_ alone {add_ms:.3f} ms, on {smi}; max |diff| vs the '
         f'kernel {err:.3g}')
    del stack, maps, grads, sweep, sweep_sum, k5, rows, seg, sums, k6
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
    _require(launches['composite_pool'] == 0,
             f'a training step launched the output pass\'s kernel: '
             f'{launches}')
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

    # ---- 12. a large mesh: the benchmark's dense-mesh cell ----
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
    _large_mesh_phase(dev, smi, args.seed)

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
    _require(launches8['segment_sum'] >= 1 and launches8['tex_scatter'] >= 1,
             'the ts 8 step did not sum its vertex gradient by segments and '
             f'its texture gradient by the texture scatter: {launches8}')
    ts8_ms = _time_ms(lambda: _grad_step(step8, (v[:4], t8)), reps=3)
    _log(f'ts 8 training step, bs 4, {OUT_SIZE}^2 AA: vertex and texture '
         f'gradients bitwise equal on a repeat step; {ts8_ms:.3f} ms a step '
         f'on {smi}; launches {launches8}')
    del g1, g2, t8

    # the ts 8 texture gradient as the backward computes it on the card (the
    # texture scatter's kernel, from the forward's tile lists) against its
    # plain version (index_add_ of the corner rows in order) on CPU copies
    # of the same maps, timed against the plain version on the card
    s8 = RasterizeSettings(image_size=RASTER, eps=1e-3, return_alpha=False,
                           return_depth=False)
    tex8 = rng.uniform(0, 1, (faces.shape[0], 8, 8, 8, 3)).astype(np.float32)
    fc8, tx8 = _raster_inputs(vertices, faces, tex8, eyes[::2], RASTER, dev)
    maps8, grads8 = _bwd_scene(s8, fc8, tx8, rng, dev)
    tex_maps = (maps8['face_index_map'], maps8['z'].permute(0, 2, 3, 1),
                maps8['weights'].permute(0, 2, 3, 1), maps8['depth_map'],
                grads8['g_rgb'])
    shape8 = tuple(tx8.shape)
    bins8 = maps8['bins']
    del fc8, tx8, maps8, grads8
    ts8 = _tex_scatter_check('ts 8, bs 4', s8, tex_maps, shape8, bins8)
    tex_err = ts8['max_abs_err']
    ts8['ms'] = _time_ms(lambda: tex.grad_textures(s8, *tex_maps, shape8,
                                                   bins8), reps=3)
    ts8['plain_ms'] = _time_ms(lambda: tex.grad_textures_plain(
        s8, *tex_maps, shape8), reps=3)
    _log(f'ts 8 texture gradient, bs 4, {RASTER}^2: the texture scatter '
         f'against the plain version on the CPU, max abs err {tex_err:.3g} '
         f'({SEGMENT_TOL} x column max), repeat runs bitwise equal, every '
         f'cell written, {ts8["faces"] - ts8["faces_won"]} faces without a '
         f'pixel all zeros; a call {ts8["ms"]:.3f} ms, the plain version on '
         f'the card {ts8["plain_ms"]:.3f} ms on {smi}')
    del tex_maps, bins8

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
    seg_worst = 0.0
    for name, ids, nseg in seg_cases:
        rows, perm, offsets, err = _compare_segments(name, ids, nseg, rng,
                                                     dev)
        seg_worst = max(seg_worst, err)

        def kern():
            return segments.segment_sum(rows, perm, offsets)

        def plain_fn():
            return segments.segment_sum_plain(rows, perm, offsets)

        def library_fn():
            return torch.zeros((nseg + nseg // 3 + 1, 3), device=dev
                               ).index_add_(0, ids, rows)

        # a call against one index_add_ in turns, 5 rounds of 20 calls
        # each: the medians (a call is host time, which spreads)
        rounds = [(_time_ms(kern, reps=20, warmup=2),
                   _time_ms(library_fn, reps=20, warmup=2))
                  for _ in range(5)]
        seg = dict(ms=float(np.median([k for k, _ in rounds])),
                   plain_ms=_time_ms(plain_fn, reps=5),
                   alone_ms=_kernel_device_ms(kern, 5, 'segment_sum_kernel'),
                   library_ms=float(np.median([x for _, x in rounds])),
                   calls_won=sum(k <= x for k, x in rounds))
        used = int(offsets[-1])
        # rows read once through their permutation, offsets, sums written
        seg['bound_ms'], seg['bound_by'] = _bound(
            (4 * 3 + 8) * used + 8 * (nseg + 1) + 4 * 3 * nseg, 3 * used)
        _log(f'segment_sum {name}: {used} rows onto {nseg} segments, max abs '
             f'err {err:.3g} ({SEGMENT_TOL} x column max), '
             f'repeat runs bitwise equal; a call {seg["ms"]:.3f} ms, alone '
             f'{_fmt_ms(seg["alone_ms"])}, plain {seg["plain_ms"]:.3f} ms, '
             f'index_add_ {seg["library_ms"]:.3f} ms (medians of 5 rounds '
             f'in turns; the call at or below index_add_ in '
             f'{seg["calls_won"]} of 5), bound '
             f'{seg["bound_ms"]:.4f} ms by {seg["bound_by"]} on {smi}')
        if name == 'vertices':
            seg_main = seg
        else:
            seg_ts8 = seg
        del rows, perm, offsets
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

    # ---- 17. the examples at their own size ----
    torch.cuda.empty_cache()
    example_launches = _examples_phase(dev, smi)

    # ---- 18. the gradient-quality study ----
    _grad_quality_phase(smi)

    # ---- 19. the dataset renderer and the real model ----
    torch.cuda.empty_cache()
    render_launches, fworst, iworst19 = _render_phase(dev, smi, rng, bworst)
    worst = max(worst, fworst)
    iworst = max(iworst, iworst19)

    # ---- 20. the reference timing protocol ----
    torch.cuda.empty_cache()
    protocol_launches, seg_err20 = _protocol_phase(dev, smi, rng, bworst)
    seg_worst = max(seg_worst, seg_err20)

    # ---- 21. BASELINE config 5: 64 views at 512^2 ----
    torch.cuda.empty_cache()
    multiview_launches, fworst, iworst21 = _multiview_phase(dev, smi)
    worst = max(worst, fworst)
    iworst = max(iworst, iworst21)

    # ---- 22. the output pass's kernel ----
    torch.cuda.empty_cache()
    cpool = _composite_pool_phase(dev, smi, rng)

    # ---- 23. the face gradient's assembly ----
    torch.cuda.empty_cache()
    fgrad = _face_grad_phase(dev, smi, rng)

    # ---- 24. host values kept on the card ----
    torch.cuda.empty_cache()
    _kept_phase(dev, smi, args.seed)

    # ---- 25. the K6 factors inside the reduction ----
    torch.cuda.empty_cache()
    extra['face_reduce']['teapot_cells'] = _k6_reduce_phase(dev, smi,
                                                            args.seed)

    # ---- 26. the path of cubes above ts 4, at ts 16 ----
    torch.cuda.empty_cache()
    ts16 = _ts16_phase(dev, smi, args.seed)

    # ---- 27. what tracing costs ----
    torch.cuda.empty_cache()
    tracing_cost = _tracing_phase(dev, smi, args.seed)
    extra['segment_sum'] = {}

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
    sources.update({
        'bin_faces': ('neural_renderer_torch/csrc/bin_faces.cu',
                      'XLA code, not a TPU kernel: neural_renderer_tpu/'
                      'rasterize/forward_pallas.py:211-299 '
                      '(_face_tile_ranges, _membership_prefix, '
                      '_feature_table)', 0.0, launches),
        'segment_sum': ('neural_renderer_torch/csrc/segment_sum.cu',
                        'XLA code, not a TPU kernel: neural_renderer_tpu/ops/'
                        'vertices_to_faces.py:57-93', seg_worst, launches),
    })
    times['bin_faces'] = (binning_times['ms'], binning_times['plain_ms'])
    bounds['bin_faces'] = (binning_times['bound_ms'],
                           binning_times['bound_by'])
    alone['bin_faces'] = binning_times['alone_ms']
    library['bin_faces'] = None
    extra['bin_faces'] = {k: binning_times[k] for k in (
        'sync_wait_ms', 'op_ms', 'device_ops', 'plain_device_ops', 'pairs',
        'model_24_views')}
    times['segment_sum'] = (seg_main['ms'], seg_main['plain_ms'])
    bounds['segment_sum'] = (seg_main['bound_ms'], seg_main['bound_by'])
    alone['segment_sum'] = seg_main['alone_ms']
    library['segment_sum'] = seg_main['library_ms']
    extra['segment_sum'].update(step_profile_ms=segment_step_ms,
                                ts8_texture_scale=seg_ts8)
    sources['composite_pool'] = (
        'neural_renderer_torch/csrc/composite_pool.cu',
        'XLA code, not a TPU kernel: neural_renderer_tpu/rasterize/'
        'api.py:84-88 and the composite of its core', 0.0, launches)
    times['composite_pool'] = (cpool['ms'], cpool['plain_ms'])
    bounds['composite_pool'] = (cpool['bound_ms'], cpool['bound_by'])
    alone['composite_pool'] = cpool['alone_ms']
    library['composite_pool'] = None
    extra['composite_pool'] = dict(config5_call_launches=cpool['launches'],
                                   **cpool['extra'])
    sources['face_grad'] = (
        'neural_renderer_torch/csrc/face_reduce.cu',
        'XLA code, not a TPU kernel: neural_renderer_tpu/rasterize/'
        'backward.py:540-565 (scatter_pixel_channels) and the K7 add',
        0.0, launches)
    times['face_grad'] = (fgrad['ms'], fgrad['plain_ms'])
    bounds['face_grad'] = (fgrad['bound_ms'], fgrad['bound_by'])
    alone['face_grad'] = fgrad['alone_ms']
    library['face_grad'] = None
    extra['face_grad'] = dict(phase23_launches=fgrad['launches'],
                              **fgrad['extra'])
    sources['tex_scatter'] = (
        'neural_renderer_torch/csrc/tex_scatter.cu',
        'XLA code, not a TPU kernel: neural_renderer_tpu/rasterize/'
        'texture.py:275-289 (the 8-corner scatter of cubes above ts 4)',
        max([tex_err, *ts16['max_abs_err'].values()]
            + [c['max_abs_err'] for c in ts16['scatter'].values()]),
        launches)
    scatter_t = ts16['timing']
    times['tex_scatter'] = (scatter_t['ms'], scatter_t['plain_ms'])
    bounds['tex_scatter'] = (scatter_t['bound_ms'], scatter_t['bound_by'])
    alone['tex_scatter'] = scatter_t['alone_ms']
    library['tex_scatter'] = scatter_t['library_ms']
    extra['tex_scatter'] = dict(ts16_cell=ts16, ts8_bs4=ts8)
    _log(json.dumps({'tracing': tracing_cost}))
    _log(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
        'launches': counts[name],
        'launches_per_step': counts[name] / len(eyes), 'max_abs_err': err_k,
        'ms': times[name][0], 'plain_ms': times[name][1],
        'bound_ms': bounds[name][0], 'bound_by': bounds[name][1],
        'library_ms': library.get(name), 'kernel_alone_ms': alone[name],
        'examples_launches': {ex: c[name]
                              for ex, c in example_launches.items()},
        'phase19_launches': {path: c[name]
                             for path, c in render_launches.items()},
        'phase20_launches': {path: c[name]
                             for path, c in protocol_launches.items()},
        'phase21_launches': {path: c[name]
                             for path, c in multiview_launches.items()},
        **extra.get(name, {}),
    } for name, (src, rep, err_k, counts) in sources.items()]}))
    _log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
