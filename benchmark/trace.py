"""The traced stretches of a run, reduced from ``torch.profiler``'s events
to what the per-layer metrics read.

A traced run profiles two stretches of the same number of calls.  The
first traces the device alone, so the host keeps its own pace: its device
operations (kernels, copies, sets; not the spans that ``record_function``
marks on the device's timeline) and its length on the host clock give the
operation counts, the kernels' times, the busy time and the idle share.
The second traces the host as well (every operation is recorded, which
slows the host): its host events and spans give the host's waits and what
the host was doing in each idle gap.  Times are in microseconds on the
profiler's clock.  A helper that finds nothing to read returns None.
"""

import collections

SPAN_PREFIX = 'bench.'
WINDOW_SPAN = 'bench.window'
CALL_SPAN = 'bench.call'
SYNC_SPAN = 'bench.sync'
TOP = 10


def _kind(name):
    return ('copy' if name.startswith('Memcpy') else
            'set' if name.startswith('Memset') else 'kernel')


def _events(prof):
    """(device operations, host events, the WINDOW_SPAN's interval)."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # a record_function span shows on the device's timeline too
            if getattr(ev, 'is_user_annotation', False) or \
                    ev.name.startswith(SPAN_PREFIX):
                continue
            device.append((ev.name, tr.start, tr.end, _kind(ev.name)))
        else:
            host.append((ev.name, tr.start, tr.end, ev.thread))
            if ev.name == WINDOW_SPAN:
                window = (tr.start, tr.end)
    return device, host, window


def record(device_prof, host_prof, calls, seconds, work=None):
    """The two stretches of ``calls`` calls each: ``device_prof`` traced
    the device alone for ``seconds`` of host clock, ``host_prof`` the host
    too; ``work`` holds the counts of ``roofline`` per call, by name."""
    device, _, _ = _events(device_prof)
    host_device, host, window = _events(host_prof)
    return dict(calls=calls, device=device, seconds=seconds,
                host=host, host_device=host_device, window=window,
                work=work or {})


def short_name(name):
    """A device operation's name without namespaces, template arguments
    and parameters."""
    name = name.replace('(anonymous namespace)::', '')
    name = name[5:] if name.startswith('void ') else name
    return name.split('<')[0].split('(')[0].split('::')[-1].strip()


def matches(name, patterns):
    return any(p in name for p in patterns)


def device_ops_per_call(rec):
    if not rec['device']:
        return None
    return len(rec['device']) / rec['calls']


def kernel_seconds(rec, patterns, exclude=False):
    """Seconds of the kernels whose names hold one of ``patterns`` (or,
    with ``exclude``, of every other kernel), summed over the stretch;
    None where no kernel is counted."""
    total, seen = 0.0, False
    for name, t0, t1, kind in rec['device']:
        if kind != 'kernel' or matches(name, patterns) == exclude:
            continue
        total += (t1 - t0) * 1e-6
        seen = True
    return total if seen else None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(rec):
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in _union(
        (t0, t1) for _, t0, t1, _ in rec['device'])) * 1e-6


def window_seconds(rec):
    """The device stretch's length on the host clock."""
    return rec['seconds']


def idle_pct(rec):
    if not rec['device']:
        return None
    return 100.0 * (1.0 - busy_seconds(rec) / window_seconds(rec))


def roofline_pct(rec, work_key, patterns):
    """100 x the least time of ``rec['work'][work_key]`` (per call) over
    the device time per call of the kernels ``patterns`` name."""
    from benchmark import roofline
    got = kernel_seconds(rec, patterns)
    work = rec['work'].get(work_key)
    if got is None or work is None:
        return None
    least, _ = roofline.least_seconds(work['bytes'], work['ops'])
    return 100.0 * least / (got / rec['calls'])


def _inside(rec, name):
    """Host intervals of the spans called ``name``."""
    return sorted((t0, t1) for n, t0, t1, _ in rec['host'] if n == name)


def host_waits_per_call(rec):
    """Per call of the host stretch: pageable host-to-device copies on the
    device, plus host ``cuda*Synchronize`` calls outside the harness's own
    synchronize (``SYNC_SPAN``)."""
    if not rec['host_device']:
        return None
    pageable = sum(1 for n, _, _, _ in rec['host_device']
                   if n.startswith('Memcpy HtoD (Pageable'))
    own = _inside(rec, SYNC_SPAN)
    syncs = 0
    for n, t0, t1, _ in rec['host']:
        if n.startswith('cuda') and n.endswith('Synchronize'):
            if not any(s <= t0 and t1 <= e for s, e in own):
                syncs += 1
    return (pageable + syncs) / rec['calls']


def breakdown(rec):
    """{'device_ops': the device operations that took most time, summed
    over the device stretch, 'idle_gaps': the device's idle time in the
    host stretch's window summed by the innermost host event running at
    each gap's middle}, each a list of [name, seconds], longest first."""
    ops = collections.Counter()
    for name, t0, t1, _ in rec['device']:
        ops[short_name(name)] += (t1 - t0) * 1e-6
    gaps = collections.Counter()
    if rec['window'] is not None:
        w0, w1 = rec['window']
        busy = _union((max(t0, w0), min(t1, w1))
                      for _, t0, t1, _ in rec['host_device']
                      if t1 > w0 and t0 < w1)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        spans = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
        host = sorted((t0, t1, n) for n, t0, t1, _ in rec['host']
                      if n != WINDOW_SPAN)
        active, k = [], 0
        for s, e in spans:
            mid = 0.5 * (s + e)
            while k < len(host) and host[k][0] <= mid:
                active.append(host[k])
                k += 1
            active = [h for h in active if h[1] >= mid]
            inner = min(active, key=lambda h: h[1] - h[0], default=None)
            gaps[inner[2] if inner else 'no host event'] += (e - s) * 1e-6
    return dict(device_ops=[[n, s] for n, s in ops.most_common(TOP)],
                idle_gaps=[[n, s] for n, s in gaps.most_common(TOP)])
