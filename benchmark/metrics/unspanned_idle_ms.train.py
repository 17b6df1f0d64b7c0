"""Device idle ms per call in the traced stretch while the host was inside
no ``nr.scene``, ``nr.raster`` or ``nr.backward`` span on any thread: the
idle that no layer of the program explains (the harness's loop, the loss
and its gradient seed, the hand-off to the autograd engine's thread).
With ``scene_idle_ms``, ``raster_idle_ms`` and ``backward_idle_ms`` it
splits the window's idle in four."""

from benchmark import spans, trace

LAYERS = ('scene', 'raster', 'backward')


def _in_layers(name):
    return any(name == spans.PREFIX + layer
               or name.startswith(spans.PREFIX + layer + '.')
               for layer in LAYERS)


def read(rec):
    # None where the stretch holds no span, no device operation or no
    # window, as the layers' readers
    if spans.idle_ms_per_call(rec, LAYERS[0]) is None:
        return None
    w0, w1 = rec['window']

    def clipped(intervals):
        return trace._union((max(t0, w0), min(t1, w1))
                            for t0, t1 in intervals if t1 > w0 and t0 < w1)

    def length(intervals):
        return sum(e - s for s, e in intervals)

    busy = clipped((t0, t1) for _, t0, t1, _ in rec['host_device'])
    inside = clipped((t0, t1) for n, t0, t1 in spans._spans(rec)
                     if _in_layers(n))
    # the window's idle less the idle inside the layers' spans
    idle = ((w1 - w0) - length(busy)
            - (length(inside) - spans._overlap(inside, busy)))
    return idle * 1e-3 / rec['calls']
