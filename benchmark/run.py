"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Needs as many CUDA devices as the cell
asks for; without them it exits with code 2 and prints no result.  The
last line of standard output is the result (JSON); the numbers compared
with the plain reference are also the last lines of standard error, each
beside its limit.  With ``--trace 1`` the metrics are the cell's
per-layer ones, read from a profiled stretch of the window.
"""

import time

START = time.time()

import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
# keep libraries from loading JAX on their own
os.environ.setdefault('USE_FLAX', '0')
# one process with few threads: the host side is what the cells' loops
# wait on, and idle pools of worker threads only add to its jitter
os.environ.setdefault('OMP_NUM_THREADS', '1')

import torch

from benchmark import harness


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    bench = harness.load_bench()
    cell = harness.named(bench['workloads'], args.workload, 'workload')
    if not torch.cuda.is_available():
        harness.log('no CUDA device: the benchmark runs on the card only')
        return 2
    if torch.cuda.device_count() < cell['chips']:
        harness.log(f"cell {args.workload} needs {cell['chips']} CUDA "
                    f'devices; {torch.cuda.device_count()} seen')
        return 2
    try:
        result, rows = harness.run_cell(args.workload, args.seed,
                                        args.seconds, bool(args.trace),
                                        START, bench=bench)
    except harness.RunError as err:
        harness.log(f'run failed: {err}')
        return 1
    found = harness.forbidden_modules()
    if found:
        harness.log(f'the run loaded {", ".join(found)}: the benchmark '
                    'measures the PyTorch port alone')
        return 3
    for name, value, limit in rows:
        harness.log(f'{name} {value!r} limit {limit!r}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
