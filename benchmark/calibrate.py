"""Readings behind a cell's limits, on the card at the cell's own size: the
numbers ``check.compare`` gives for the program and for the
lower-precision control (``check.control``), on several seeds in one
process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3]

For each seed: the inputs a run with that seed makes, as many calls as a
run checks (``check.calls``, from the seed's offset) and in each the
elements a run would draw, the program's outputs of those answers and the
control's, each held against the plain reference.  Prints one JSON line per seed and one with the largest
program reading and the smallest control reading of each number.  The
benchmark's own runs do not run this.
"""

import time

START = time.time()

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch

from benchmark import check, harness
from benchmark.reference import renderer as ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control-seeds', type=int, nargs='*', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log('no CUDA device')
        return 2
    import neural_renderer_torch as nt

    bench = harness.load_bench()
    _, cfg, traffic = harness.load_cell(bench, args.workload)
    dev = torch.device('cuda', 0)
    harness._prebuild(nt)
    controls = (args.seeds[:3] if args.control_seeds is None
                else args.control_seeds)
    block = traffic['check']['block']
    worst = {'program': {}, 'control': {}}
    for seed in args.seeds:
        prog = harness.Program(nt, cfg, traffic, seed, dev)
        sample = harness.Sample(traffic['check'], traffic['batch'], seed)
        for i in range(traffic['check']['calls']):
            sample.offer(i, prog.call(i))
        prog.synchronize()
        line = dict(seed=seed, program=[], control=[])
        for i, idx, images, grads in sample.items:
            inputs = (cfg, traffic['entry'], traffic['grads'],
                      *prog.inputs(i, idx), block)
            want = ref.run(*inputs)
            line['program'].append(check.compare(images, grads, *want))
            if seed in controls:
                line['control'].append(check.compare(
                    *check.control(*inputs), *want))
        del prog, sample
        torch.cuda.empty_cache()
        for side in ('program', 'control'):
            got = check.worst(line[side])
            line[side] = got
            for k, v in got.items():
                pick = max if side == 'program' else min
                worst[side][k] = pick(worst[side].get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(workload=args.workload,
                          seeds=len(args.seeds),
                          program_max=worst['program'],
                          control_min=worst['control'],
                          seconds=time.time() - START)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
