"""A/B of the port's out-sweep kernel instances on one NVIDIA GPU.

The out-sweep (``neural_renderer_torch/csrc/backward_sweeps.cu``) has an
instance with the crossing list in rounds and one without them, which a
staged line whose whole list fits may run.  ``launch_out`` picks the
instance without rounds for rgb alone and alpha alone, the instance with
rounds for rgb and alpha together.  This script builds three copies of the
source (as it stands, with the instance without rounds for every mode, and
with rounds for every mode), prints ptxas' registers and spills of each
out-sweep instance, checks that the three agree bit for bit, and times
them at the main path's shape (the teapot, batch 32, 512^2 raster, ts 2,
``accumulate=True``, the rasterizer's own forward maps and random output
gradients from ``--seed``) in each mode, in the order A B C C B A: CUDA
events over 30 calls and the kernel's device time from torch.profiler.

Run from the repository root:  python3 misc/torch_outsweep_instances.py
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import neural_renderer_torch as nt  # noqa: E402
from neural_renderer_torch import _build  # noqa: E402
from neural_renderer_torch.rasterize import backward_cuda  # noqa: E402
from neural_renderer_torch.rasterize.config import RasterizeSettings  # noqa: E402

PICK = 'if constexpr (!(RGB && ALPHA)) {'
LIMITS = '  const int limits[] = {\n'
IS = 512


def _variants(src):
    assert src.count(PICK) == 1 and src.count(LIMITS) == 1
    everywhere = src.replace(PICK, 'if constexpr (true) {').replace(
        LIMITS, LIMITS + '      dynamic_smem_limit<true, true, true, false>(),\n')
    return {'as built': src, 'one round everywhere': everywhere,
            'rounds everywhere': src.replace(PICK, 'if constexpr (false) {')}


def _build_all(variants, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k, (name, text) in enumerate(variants.items()):
        path = os.path.join(out_dir, f'outsweep_{k}.cu')
        with open(path, 'w') as fh:
            fh.write(text)
        procs[name] = (path[:-3] + '.so', subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, '-o', path[:-3] + '.so', path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if 'Function properties' in line and 'outsweep_kernel' in line:
                inst = re.search(r'outsweep_kernelI(\w+?)EEv', line).group(1)
                flags = ''.join(re.findall(r'Lb(\d)E', inst + 'E'))
                print(f'{name}: outsweep_kernel<RGB, ALPHA, STAGED, ROUNDS> '
                      f'= {flags}: {lines[i + 1].strip()}; '
                      f'{lines[i + 2].split(":", 1)[1].strip()}')
        handle = ctypes.CDLL(lib)
        ptr, i32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                              ctypes.c_longlong)
        st = ctypes.POINTER(i64)
        handle.nr_outsweep.argtypes = [ptr, ptr, ptr, st, ptr, st, ptr, i32,
                                       i32, f32, ptr, i64, i32, i32, i32, ptr]
        handle.nr_outsweep.restype = i32
        handle.nr_error_string.argtypes = [i32]
        handle.nr_error_string.restype = ctypes.c_char_p
        libs[name] = handle
    return libs


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    src_path = os.path.join(ROOT, 'neural_renderer_torch', 'csrc',
                            'backward_sweeps.cu')
    with open(src_path) as fh:
        libs = _build_all(_variants(fh.read()),
                          os.path.join(ROOT, 'neural_renderer_torch', '_build',
                                       'outsweep_instances'))
    rng = np.random.RandomState(args.seed)
    vertices, faces = cs._teapot()
    eyes = [nt.get_points_from_angles(cs.DISTANCE, cs.ELEVATION, a)
            for a in cs.AZIMUTHS]
    tex2 = rng.uniform(0, 1, (faces.shape[0], 2, 2, 2, 3)).astype(np.float32)
    fc, tx = cs._raster_inputs(vertices, faces, tex2,
                               [e for e in eyes for _ in range(4)], IS, dev)
    for rgb_on, alpha in ((True, False), (False, True), (True, True)):
        mode = ' + '.join(n for n, on in (('rgb', rgb_on), ('alpha', alpha))
                          if on)
        s = RasterizeSettings(image_size=IS, eps=1e-3, return_rgb=rgb_on,
                              return_alpha=alpha, return_depth=False)
        maps, grads = cs._bwd_scene(s, fc, tx, rng, dev)
        sw = cs._sweep_args(s, maps, grads)
        rgb, grgb = sw[3], sw[4]
        ga = grads['g_alpha'].contiguous() if alpha else None
        xy, fim = maps['xy'].contiguous(), maps['face_index_map'].contiguous()
        base = backward_cuda.insweep(*sw)

        def runner(name, out):
            lib = libs[name]

            def run():
                rc = lib.nr_outsweep(
                    xy.data_ptr(), fim.data_ptr(), backward_cuda._ptr(rgb),
                    backward_cuda._strides(rgb), backward_cuda._ptr(grgb),
                    backward_cuda._strides(grgb),
                    None if ga is None else ga.data_ptr(), fc.shape[0], IS,
                    s.eps, out.data_ptr(), out.stride(0), 1, 1, 3 * IS,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f'{name}: '
                                       + lib.nr_error_string(rc).decode())
            return run

        outs = {}
        for name in libs:
            outs[name] = base.clone()
            runner(name, outs[name])()
        torch.cuda.synchronize()
        first = next(iter(outs.values()))
        cs._require(all(torch.equal(o, first) for o in outs.values()),
                     f'{mode}: the instances disagree')
        times = {name: [] for name in libs}
        names = list(libs)
        for name in names + names[::-1]:
            run = runner(name, base.clone())
            times[name].append((cs._time_ms(run, reps=30, warmup=3),
                                cs._kernel_device_ms(run, 10,
                                                     'outsweep_kernel')))
        print(f'{mode}, bs {fc.shape[0]}, {IS}^2, accumulate: the instances '
              'agree bit for bit; ' + '; '.join(
                  f'{name} ' + ' / '.join(
                      f'{ev:.4f} ms (alone {cs._fmt_ms(alone)})'
                      for ev, alone in t) for name, t in times.items()))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(f'card: {smi}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
