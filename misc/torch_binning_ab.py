"""A/B of the setup and binning (``csrc/bin_faces.cu``) and the segmented sum
(``csrc/segment_sum.cu``) between two trees of the port on one NVIDIA GPU.

Each side runs in a child process that imports ``neural_renderer_torch``
from its own tree (built there at first use) and measures, on the same
inputs from ``--seed``:
  * ``forward_cuda.bin_setup`` at the main path's shape (the teapot, batch
    32, 512^2 raster, as ``forward_shaded`` bins it) and on the real model's
    24 views: the call (CUDA events over 20 calls), its device time and
    device operations per call (torch.profiler), each operation's time;
  * ``segments.segment_sum`` at the main path's vertex scatter and at the
    ts 8 texture scatter's scale: the call, the kernel alone, and one
    ``index_add_`` of the same rows;
  * the main path's training step and forward render (the teapot, batch 32,
    256^2 AA, ts 2, over the 8 bench azimuths): device time, device
    operations and wall time per step (torch.profiler, one sweep each).
The sides run in the order A B B A (``--tree`` first), and the script
prints one JSON line per run and the card's name and power limit.

Run from the repository root, with the other tree unpacked inside it (for
example ``git archive <commit> | tar -x -C build/parent``):
    python3 misc/torch_binning_ab.py --tree build/parent
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')


def _child(tree, seed):
    """Measure the port of ``tree`` (its package first on sys.path) with
    this tree's chip_smoke.py helpers; print one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import importlib.util

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    nt = cs.nt
    from neural_renderer_torch import _build
    from neural_renderer_torch.ops import segments
    from neural_renderer_torch.rasterize import forward_cuda
    from neural_renderer_torch.rasterize.config import RasterizeSettings
    assert os.path.abspath(nt.__file__).startswith(os.path.abspath(tree))
    dev = torch.device('cuda', 0)
    _build.build_all(cs.KERNELS)
    rng = np.random.RandomState(seed)
    out = dict(tree=tree)

    vertices, faces = cs._teapot()
    eyes = [nt.get_points_from_angles(cs.DISTANCE, cs.ELEVATION, a)
            for a in cs.AZIMUTHS]
    tex2 = rng.uniform(0, 1, (faces.shape[0], 2, 2, 2, 3)).astype(np.float32)
    fc32, _ = cs._raster_inputs(vertices, faces, tex2,
                                [e for e in eyes for _ in range(4)],
                                cs.RASTER, dev)
    s512 = RasterizeSettings(image_size=cs.RASTER, eps=1e-3)
    tr = cs._load_script(os.path.join(ROOT, 'misc', 'torch_render.py'))
    vm, fm, tm = tr.load_mesh(cs.MODEL, 2, dev)
    views = nt.Renderer()
    views.image_size = cs.OUT_SIZE
    views.eye = tr.view_eyes(24, cs.DISTANCE, cs.ELEVATION, dev)
    fc24, _ = views._lit_faces(vm.expand(24, -1, -1), fm.expand(24, -1, -1),
                               tm.expand((24,) + tm.shape[1:]))
    tile = forward_cuda._kernel().nr_forward_shaded_tile()
    for name, fc in (('teapot', fc32), ('model', fc24)):
        def binning():
            return forward_cuda.bin_setup(s512, fc, tile)
        ops = cs._device_ops(binning)
        op_ms = cs._op_times(binning)
        out[f'bin_{name}'] = dict(
            ms=cs._time_ms(binning, 20, 3),
            device_ms=sum(v for k, v in op_ms.items() if 'Memcpy' not in k),
            device_ops=ops['kernels'] + ops['memsets'], op_ms=op_ms)

    fb = nt.Renderer._fill_back_faces(torch.as_tensor(
        np.tile(faces[None], (cs.BATCH, 1, 1)), device=dev).long())
    nv = vertices.shape[0]
    flat = (fb + (torch.arange(cs.BATCH, device=dev) * nv)[:, None, None]
            ).reshape(-1)
    n8, nseg8 = 8 * 4 * cs.RASTER * cs.RASTER, 4 * fb.shape[1] * 8 ** 3
    for name, ids, nseg in (
            ('vertices', flat, cs.BATCH * nv),
            ('ts8', torch.as_tensor(rng.randint(0, nseg8 + nseg8 // 3, n8),
                                    device=dev), nseg8)):
        rows = torch.as_tensor(rng.normal(0, 1, (ids.shape[0], 3)).astype(
            np.float32), device=dev)
        perm, offsets = segments.sort_segments(ids, nseg)

        def kern():
            return segments.segment_sum(rows, perm, offsets)

        def library():
            return torch.zeros((nseg + nseg // 3 + 1, 3), device=dev
                               ).index_add_(0, ids, rows)
        out[f'segment_sum_{name}'] = dict(
            ms=cs._time_ms(kern, 20, 2),
            alone_ms=cs._kernel_device_ms(kern, 5, 'segment_sum_kernel'),
            index_add_ms=cs._time_ms(library, 20, 2))

    v = torch.as_tensor(np.tile(vertices[None], (cs.BATCH, 1, 1)),
                        device=dev)
    f = torch.as_tensor(np.tile(faces[None], (cs.BATCH, 1, 1)), device=dev)
    vg = v.clone().requires_grad_()
    tg = torch.as_tensor(np.tile(tex2[None], (cs.BATCH, 1, 1, 1, 1, 1)),
                         device=dev).requires_grad_()
    r = nt.Renderer()
    r.image_size = cs.OUT_SIZE

    def step(eye):
        r.eye = eye
        vg.grad = tg.grad = None
        r.render(vg, f, tg).sum().backward()

    def forward(eye):
        r.eye = eye
        with torch.no_grad():
            r.render(v, f, tg)

    for name, fn in (('training_step', step), ('forward', forward)):
        fn(eyes[0])
        dev_ms, wall_ms, by, ops = cs._step_profile(fn, eyes)
        out[name] = dict(device_ms=dev_ms, profiled_wall_ms=wall_ms,
                         device_ops=sum(ops.values()),
                         segment_sum_ms=by['segment_sum'])
    print('RESULT ' + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--tree', required=True,
                    help='the other tree (A), unpacked inside this one')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--child', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child, args.seed)
        return 0
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    for tree in (args.tree, ROOT, ROOT, args.tree):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--tree', args.tree,
             '--seed', str(args.seed), '--child', tree],
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            return 1
        line = [x for x in proc.stdout.splitlines()
                if x.startswith('RESULT ')][-1]
        run = json.loads(line[len('RESULT '):])
        run['side'] = 'A' if tree == args.tree else 'B'
        print(json.dumps(run), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
