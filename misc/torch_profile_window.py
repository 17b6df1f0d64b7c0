"""Does a short torch.profiler window lose the card's kernels?

Repeatedly profiles a window of 5 launches of the segmented sum
(``csrc/segment_sum.cu``, ~8 us each at the main path's vertex scatter's
size) twice: as ``chip_smoke.py`` profiled before its windows were padded
(the launches, then a synchronize), and padded with ``--pad`` seconds of
idle host time at both ends.  Between windows the card multiplies 4096^2
matrices for a while, as a long run keeps it busy.  For each window it
prints the launches the profiler caught and each kernel's start minus its
launch's start in the trace (the card's clock against the host's), and at
the end how many windows lost launches.

    python misc/torch_profile_window.py [--seconds 200] [--pad 0.05]

Needs the card.
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))

import argparse
import json
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from neural_renderer_torch.ops import segments

LAUNCHES = 5


def window(call, pad, trace):
    """(launches caught, [kernel start - launch start, us]) of one profiled
    window of ``LAUNCHES`` calls, ``pad`` s of idle host time at each end."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(LAUNCHES):
            call()
        torch.cuda.synchronize()
        time.sleep(pad)
    caught = sum(1 for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and 'segment_sum_kernel' in ev.name)
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)['traceEvents']
    launched = sorted(float(e['ts']) for e in events
                      if e.get('cat') == 'cuda_runtime'
                      and 'LaunchKernel' in e['name'])
    started = sorted(float(e['ts']) for e in events
                     if e.get('cat') == 'kernel')
    return caught, [round(k - s, 1) for k, s in zip(started, launched)]


def run(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seconds', type=float, default=200.0)
    ap.add_argument('--pad', type=float, default=0.05)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this measures the card')
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, 40000, (470000,), device=dev, generator=g)
    rows = torch.randn(470000, 3, device=dev, generator=g)
    perm, offsets = segments.sort_segments(ids, 40000)

    def call():
        return segments.segment_sum(rows, perm, offsets)

    call()
    a = torch.randn(4096, 4096, device=dev, generator=g)
    lost = {0.0: 0, args.pad: 0}
    windows, skews = 0, []
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, 'trace.json')
        while time.time() - t0 < args.seconds:
            for _ in range(200):
                a = (a @ a).clamp_(-1, 1)
            row = []
            for pad in lost:
                caught, skew = window(call, pad, trace)
                lost[pad] += caught < LAUNCHES
                skews += skew
                row.append(f'pad {pad} s: {caught} of {LAUNCHES} caught, '
                           f'kernel - launch {skew} us')
            windows += 1
            print(f't={time.time() - t0:6.1f} s  ' + '; '.join(row),
                  flush=True)
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'windows': windows,
                      'lost_unpadded': lost[0.0],
                      'lost_padded': lost[args.pad], 'pad_s': args.pad,
                      'skew_us': [min(skews), max(skews)]}))
    return lost


if __name__ == '__main__':
    run()
