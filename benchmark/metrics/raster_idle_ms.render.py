"""Device idle ms per call in the traced stretch while the host was inside
``nr.raster`` spans: the rasterizer's forward (binning, launch, composite,
flips and pools)."""

from benchmark import spans


def read(rec):
    return spans.idle_ms_per_call(rec, 'raster')
