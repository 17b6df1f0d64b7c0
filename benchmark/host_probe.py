"""How far a slower host moves each end-to-end metric of a cell: the
evidence for which cells the card, and not the host, sets the pace of.

    python3 benchmark/host_probe.py --cells multiview.rgbad_v64 \\
        teapot.train_b128 teapot.train_b128:train_b32 --runs 3 \\
        --seconds 10 --seed 1000 [--core 1]

A probe is ``cell`` or ``cell:mix``, the cell driven by another traffic
mix of ``benchmark/traffic/`` (one that ``BENCHMARK.json`` need not list).
Each run is a process of its own pinned to one core with ``taskset``, in
one of three ways:

* ``alone``;
* ``beside`` a busy loop at ``nice -n 5`` on the same core: CFS weights of
  1024 against 335 leave the run about three quarters of the core when
  both want it (but a run that wakes from a wait preempts the loop, so
  only a run that wants more than that share is slowed);
* ``stopped`` for 1 ms in every 4 by SIGSTOP and SIGCONT from this
  process: three quarters of the wall time, whatever the run waits on.

The ways alternate, ``runs`` times each, run ``k`` of each on seed
``seed + k``.  Prints one JSON line per run, then per probe each metric's
median each way and the share it moved from ``alone`` (worse is
positive).  Needs the card; the busy loop is stopped after each run.
"""

import time

START = time.time()

import argparse
import json
import os
import pathlib
import signal
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault('USE_FLAX', '0')
os.environ.setdefault('OMP_NUM_THREADS', '1')

BUSY = 'while True:\n    pass\n'
WAYS = ('alone', 'beside', 'stopped')
# the ``stopped`` way's cycle: stopped for STOP_S of every CYCLE_S
STOP_S, CYCLE_S = 0.001, 0.004


def child(cell, mix, seed, seconds):
    """One untraced run of ``cell`` (driven by ``mix``) in this process:
    its result line."""
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        harness.log('no CUDA device')
        return 2
    result, _ = harness.run_cell(cell, seed, seconds, False, START,
                                 traffic=mix)
    print(json.dumps(result), flush=True)
    return 0


def _duty_cycle(proc):
    """Stop ``proc`` for STOP_S of every CYCLE_S until it ends."""
    while proc.poll() is None:
        try:
            proc.send_signal(signal.SIGSTOP)
            time.sleep(STOP_S)
        finally:
            proc.send_signal(signal.SIGCONT)
        time.sleep(CYCLE_S - STOP_S)


def one_run(probe, seed, seconds, core, way):
    cell, _, mix = probe.partition(':')
    cmd = ['taskset', '-c', str(core), sys.executable, __file__, '--child',
           cell, mix or '-', str(seed), str(seconds)]
    hog = None
    if way == 'beside':
        hog = subprocess.Popen(['taskset', '-c', str(core), 'nice', '-n', '5',
                                sys.executable, '-c', BUSY])
    with tempfile.TemporaryFile('w+') as out, \
            tempfile.TemporaryFile('w+') as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err,
                                text=True)
        try:
            if way == 'stopped':
                _duty_cycle(proc)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if hog is not None:
                hog.kill()
                hog.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    if rc != 0:
        raise RuntimeError(f'{probe} seed {seed}: exit {rc}\n'
                           + stderr[-2000:])
    return json.loads(stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--child', nargs=4, metavar=('CELL', 'MIX', 'SEED', 'S'))
    ap.add_argument('--cells', nargs='+', default=[])
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--seed', type=int, default=1000)
    ap.add_argument('--core', type=int, default=1)
    args = ap.parse_args(argv)
    if args.child:
        cell, mix, seed, seconds = args.child
        return child(cell, None if mix == '-' else mix, int(seed),
                     float(seconds))
    better = {m['name']: m['better'] for m in json.loads(
        (ROOT / 'BENCHMARK.json').read_text())['end_to_end']}
    for probe in args.cells:
        got = {way: [] for way in WAYS}
        for k in range(args.runs):
            for way in WAYS:
                res = one_run(probe, args.seed + k, args.seconds, args.core,
                              way)
                vals = {m: v['value'] for m, v in res['metrics'].items()}
                got[way].append(vals)
                print(json.dumps(dict(probe=probe, way=way, k=k,
                                      correct=res['correct'], metrics=vals)),
                      flush=True)
        summary = {}
        for m in got['alone'][0]:
            med = {way: statistics.median(r[m] for r in got[way])
                   for way in WAYS}
            a = med['alone']
            summary[m] = dict(med, moved={
                way: (a - b) / a if better[m] == 'higher' else (b - a) / a
                for way, b in med.items() if way != 'alone'})
        print(json.dumps(dict(probe=probe, summary=summary)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
