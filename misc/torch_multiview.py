"""BASELINE config 5 with neural_renderer_torch: batched multi-view RGB +
depth + silhouette rendering, 64 views at 512^2, sharded over a process
group.

Port of misc/multiview.py: the teapot broadcast to ``--views`` views with
white ts 2 textures, seen from a ring of eyes (azimuths ``linspace(0, 360,
views, endpoint=False)`` at ``--distance`` and ``--elevation``, an ``[n,
3]`` tensor in ``renderer.eye``), a default ``Renderer`` at
``--image_size`` (anti-aliased), ``tune`` over every ``max(1, views //
8)``-th eye, then ``parallel.make_sharded_render(renderer, group,
mode='rgbad')``: rgb, alpha and depth in one rasterization pass, each rank
rendering its slice of the views with no communication.  One warm-up call,
then ``--iters`` timed calls (host clock, ended by a device synchronize),
all under ``torch.no_grad()``.  Prints the JAX script's lines: ms per
batch, images/s, each output's shape and mean; the outputs must be finite.

The group is the launcher's under ``torchrun`` (gloo; each rank on its
``LOCAL_RANK``'s card), else a one-rank gloo group on an in-memory store,
made for the run and destroyed after it: the same path, as the JAX script
shards over a one-device mesh on one chip.  ``tune`` records its capacities
in ``renderer.perf_overrides``, which the port's kernels do not read (they
have none).

    python misc/torch_multiview.py [--views 64] [--image_size 512] \\
        [--iters 4] [--device cpu]

Runs on the card unless ``--device cpu`` is given (the plain versions).
``build(args)`` returns the scene; ``run(argv)`` returns (this rank's
outputs, timings).
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

import neural_renderer_torch as nt
from neural_renderer_torch import parallel
from neural_renderer_torch.rasterize.config import resolve_device

TEAPOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                      'tests', 'data', 'teapot.obj')
TEXTURE_SIZE = 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--views', type=int, default=64)
    ap.add_argument('--image_size', type=int, default=512)
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--distance', type=float, default=2.732)
    ap.add_argument('--elevation', type=float, default=30.0)
    ap.add_argument('--device', type=str, default='cuda')
    return ap.parse_args(argv)


def tuned_eyes(eyes):
    """The eyes ``tune`` covers: every ``max(1, n // 8)``-th of ``n``."""
    return [eyes[i] for i in range(0, len(eyes), max(1, len(eyes) // 8))]


def build(args, device=None):
    """(renderer, vertices [n, nv, 3], faces [n, nf, 3], textures [n, nf,
    2, 2, 2, 3], eyes [n, 3]) for ``n = args.views`` on ``device``
    (default ``args.device``): the teapot broadcast to the views and the
    renderer tuned over ``tuned_eyes(eyes)``, looking from all of them."""
    device = resolve_device(args.device if device is None else device)
    vertices, faces = nt.load_obj(TEAPOT)
    nv = args.views
    v, f, _ = nt.arrays_from_numpy(vertices, faces, None, device)
    v = v.expand((nv,) + v.shape)
    f = f.expand((nv,) + f.shape)
    tx = torch.ones((nv, faces.shape[0]) + (TEXTURE_SIZE,) * 3 + (3,),
                    device=device)
    # float32 math on the CPU, as the JAX script makes each eye
    azimuths = np.linspace(0, 360, nv, endpoint=False).astype(np.float32)
    eyes = torch.stack([nt.get_points_from_angles(
        np.float32(args.distance), np.float32(args.elevation), a,
        device='cpu') for a in azimuths]).to(device)

    renderer = nt.Renderer()
    renderer.image_size = args.image_size
    nt.tune(renderer, v, f, eyes=tuned_eyes(eyes))
    renderer.eye = eyes
    return renderer, v, f, tx, eyes


@contextlib.contextmanager
def process_group():
    """The launcher's group under ``torchrun`` (initialized here where it
    is not yet), else a one-rank gloo group on an in-memory store for the
    duration; yields (group, this rank's device index or None)."""
    made = False
    if not dist.is_initialized():
        if 'WORLD_SIZE' in os.environ:
            dist.init_process_group('gloo')
        else:
            dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                                    world_size=1)
        made = True
    local = os.environ.get('LOCAL_RANK')
    try:
        yield dist.group.WORLD, None if local is None else int(local)
    finally:
        if made:
            dist.destroy_process_group()


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(argv=None):
    args = parse_args(argv)
    with process_group() as (group, local):
        device = resolve_device(args.device)
        if device.type == 'cuda' and local is not None:
            device = torch.device('cuda', local)
        renderer, v, f, tx, eyes = build(args, device)
        nv, ndev = args.views, dist.get_world_size(group)
        renderer.eye = parallel.shard_batch(group, eyes)
        render = parallel.make_sharded_render(renderer, group, mode='rgbad')
        with torch.no_grad():
            out = render(v, f, tx)                       # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = render(v, f, tx)
            _sync(device)
            dt = (time.perf_counter() - t0) / args.iters
        lines = [f'{nv} views @ {args.image_size}^2 rgb+alpha+depth over '
                 f'{ndev} device(s): {dt * 1e3:.1f} ms/batch '
                 f'({nv / dt:.1f} images/s)']
        for k in ('rgb', 'alpha', 'depth'):
            if not bool(torch.isfinite(out[k]).all()):
                raise RuntimeError(f'{k}: non-finite values')
            lines.append(f'  {k}: shape {tuple(out[k].shape)}, mean '
                         f'{float(out[k].mean()):.4f}')
        if dist.get_rank(group) == 0:
            print('\n'.join(lines), flush=True)
    return out, dict(ms_per_batch=dt * 1e3, images_per_s=nv / dt,
                     ranks=ndev)


if __name__ == '__main__':
    run()
