"""Device idle ms per training step in the traced stretch while the host
was inside ``nr.backward`` spans: the program's backward nodes (the
rasterizer's and the vertex gather's), on the autograd engine's thread."""

from benchmark import spans


def read(rec):
    return spans.idle_ms_per_call(rec, 'backward')
