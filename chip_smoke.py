"""Smoke run of the PyTorch port (neural_renderer_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; progress goes to stdout):
  1. the card: ``torch.cuda.is_available()``, name and power limit;
  2. build the shaded-forward CUDA kernel from ``neural_renderer_torch/csrc``;
  3. kernel against its plain PyTorch version on the card, inputs from
     ``--seed``: random 64^2 scenes (no textures, ts 2/3/4) and the teapot at
     a 512^2 raster (bs 4 ts 2, the golden batch at ts 4, and the main path's
     bs 32 ts 2); face_index_map must match exactly, the other maps within
     the stated tolerances; both timed at the main path's shape;
  4. the main path: ``Renderer().render`` on the teapot at batch 32, 256^2
     with anti-aliasing (512^2 raster), ts 2, over the 8 bench azimuths,
     counting kernel launches;
  5. the golden check: the reference off-axis view (eye [1, 1, -2.7]) at ts
     4 against ``tests/data/teapot_aa_rgb_fingerprint.npz`` (atol 1e-5).

The last stdout line is the JSON device record; the line before it lists each
kernel with its launches on the main path, its worst error against the plain
version and both times.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import neural_renderer_torch as nt
from neural_renderer_torch import _build
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize.config import RasterizeSettings

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, 'tests', 'data')
BATCH = 32
AZIMUTHS = [float(a) for a in range(0, 360, 45)]
DISTANCE, ELEVATION = 2.732, 30.0

# kernel vs plain: the same separately rounded f32 operations in the same
# order, except that sums may be taken in another order
RTOL, ATOL = 1e-5, 1e-6
# rgb: the 8 corner terms are summed per channel in the same order, but the
# texel weights inherit the ulp noise of tif
RGB_RTOL, RGB_ATOL = 1e-4, 1e-5


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _log(*args):
    print(*args, flush=True)


def _teapot():
    vertices, faces = nt.load_obj(os.path.join(DATA, 'teapot.obj'))
    return vertices, faces


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


def _kernel_device_ms(fn, reps):
    """Device time of the CUDA kernel alone per call, from torch.profiler;
    None where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if 'shaded_kernel' in ev.key:
            total += getattr(ev, 'device_time_total',
                             getattr(ev, 'cuda_time_total', 0.0))
    return total / 1000.0 / reps if total > 0 else None


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

    # ---- 2. build ----
    t0 = time.time()
    path, log = _build.build('forward_shaded')
    forward_cuda._kernel()
    _log(f'build: {path.name} in {time.time() - t0:.1f} s')
    if log.strip():
        _log(log.strip())

    # ---- 3. kernel vs plain ----
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

    vertices, faces = _teapot()
    eyes = [nt.get_points_from_angles(DISTANCE, ELEVATION, a)
            for a in AZIMUTHS]
    s512 = RasterizeSettings(image_size=512, eps=1e-3)
    tex2 = rng.uniform(0, 1, (faces.shape[0], 2, 2, 2, 3)).astype(np.float32)
    fc4, tx4 = _raster_inputs(vertices, faces, tex2, eyes[::2], 512, dev)
    worst = max(worst, _compare('teapot 512^2 bs 4 ts 2', s512, fc4, tx4))

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
    worst = max(worst, _compare('golden batch 512^2 bs 4 ts 4', s512, fcg,
                                txg))

    fc32, tx32 = _raster_inputs(vertices, faces, tex2,
                                [e for e in eyes for _ in range(4)], 512, dev)
    worst = max(worst, _compare('teapot 512^2 bs 32 ts 2 (main path shape)',
                                s512, fc32, tx32))

    def kernel():
        return forward_cuda.forward_shaded(s512, fc32, tx32)

    def plain():
        return forward_cuda.forward_shaded_plain(s512, fc32, tx32)

    ms = _time_ms(kernel, reps=20, warmup=3)
    plain_ms = _time_ms(plain, reps=3)
    ms_again = _time_ms(kernel, reps=20)
    plain_ms_again = _time_ms(plain, reps=3)
    kernel_only = _kernel_device_ms(kernel, reps=10)
    _log(f'time at bs 32, 512^2, nf {2 * faces.shape[0]}, ts 2 on {smi}: '
         f'forward_shaded {ms:.3f} / {ms_again:.3f} ms, plain '
         f'{plain_ms:.3f} / {plain_ms_again:.3f} ms (kernel, plain, kernel, '
         'plain); kernel alone (profiler) '
         + ('not measured' if kernel_only is None
            else f'{kernel_only:.3f} ms'))

    # ---- 4. the main path ----
    v = torch.as_tensor(np.tile(vertices[None], (BATCH, 1, 1)), device=dev)
    f = torch.as_tensor(np.tile(faces[None], (BATCH, 1, 1)), device=dev)
    t = torch.ones((BATCH, faces.shape[0], 2, 2, 2, 3), device=dev)
    renderer = nt.Renderer()
    renderer.eye = eyes[0]
    renderer.render(v, f, t)                     # warm-up
    torch.cuda.synchronize()
    forward_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    images = []
    for eye in eyes:
        renderer.eye = eye
        images.append(renderer.render(v, f, t))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = forward_cuda.LAUNCHES
    _require(launches >= len(eyes),
             f'main path launched the kernel {launches} times for '
             f'{len(eyes)} renders')
    images = torch.stack(images)
    _require(tuple(images.shape) == (len(eyes), BATCH, 3, 256, 256),
             f'unexpected image shape {tuple(images.shape)}')
    _require(bool(torch.isfinite(images).all()), 'non-finite pixels')
    _require(bool((images.flatten(2).amax(-1) > 0.5).all()),
             'an empty teapot row')
    _log(f'main path: {len(eyes)} renders x batch {BATCH}, 256^2 AA, ts 2: '
         f'{elapsed:.4f} s, {len(eyes) * BATCH / elapsed:.2f} images/s '
         f'(forward only) on {smi}; kernel launches {launches}')

    # ---- 5. golden ----
    ref = np.load(os.path.join(DATA, 'teapot_aa_rgb_fingerprint.npz'))
    tz = np.ones((4, faces.shape[0], 4, 4, 4, 3), np.float32)
    img = gold.render(*nt.arrays_from_numpy(vz, fz, tz, dev)).cpu().numpy()
    err = float(np.abs(img[2] - ref['image']).max())
    _log(f'golden: AA ts 4 fingerprint max abs err {err} (atol 1e-5); '
         f'zero rows max {float(np.abs(img[[0, 1, 3]]).max())}')
    _require(err <= 1e-5, f'fingerprint differs by {err}')
    _require(np.abs(img[[0, 1, 3]]).max() == 0, 'zero rows not empty')

    _log(json.dumps({'kernels': [{
        'name': 'forward_shaded',
        'route': 'cuda',
        'source': 'neural_renderer_torch/csrc/forward_shaded.cu',
        'replaces': 'neural_renderer_tpu/rasterize/forward_pallas.py:636',
        'launches': launches,
        'max_abs_err': worst,
        'ms': ms,
        'plain_ms': plain_ms,
    }]}))
    _log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
