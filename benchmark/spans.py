"""The program's own spans in a traced stretch: the host waits it counts
where it makes them, and the device's idle time put down to the layer the
host was in.

The program marks ``nr.<name>`` spans on the profiler's clock while a
profiler runs (``neural_renderer_torch/tracing.py``): a call's root is
its entry point, its layers are ``nr.scene``, ``nr.raster`` and
``nr.backward`` (on the autograd engine's thread) with their children,
and each host wait is a ``nr.wait.<kind>.<site>`` span.  The readers take
``trace.record``'s host stretch: its host events on every thread
(``rec['host']``), its device operations (``rec['host_device']``) and the
harness's window (``rec['window']``), and give numbers per call.  Each
returns None where the stretch holds no ``nr.`` span (a program that
records nothing); the idle readers also where it holds no device
operation.
"""

from benchmark import trace

PREFIX = 'nr.'
WAIT_PREFIX = 'nr.wait.'


def _spans(rec):
    return [(n, t0, t1) for n, t0, t1, _ in rec['host']
            if n.startswith(PREFIX)]


def waits_per_call(rec):
    """``nr.wait.*`` spans per call."""
    spans = _spans(rec)
    if not spans:
        return None
    return sum(n.startswith(WAIT_PREFIX) for n, _, _ in spans) / rec['calls']


def _overlap(a, b):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_call(rec, layer):
    """Device idle time (the window less the union of device operations)
    inside the union of the spans of ``layer`` (``nr.<layer>`` and its
    children, on any thread), in ms per call."""
    spans = _spans(rec)
    if not spans or not rec['host_device'] or rec['window'] is None:
        return None
    w0, w1 = rec['window']

    def clipped(intervals):
        return trace._union((max(t0, w0), min(t1, w1))
                            for t0, t1 in intervals if t1 > w0 and t0 < w1)

    root = PREFIX + layer
    inside = clipped((t0, t1) for n, t0, t1 in spans
                     if n == root or n.startswith(root + '.'))
    busy = clipped((t0, t1) for _, t0, t1, _ in rec['host_device'])
    idle = sum(e - s for s, e in inside) - _overlap(inside, busy)
    return idle * 1e-3 / rec['calls']
