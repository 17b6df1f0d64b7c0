"""Device idle ms per call in the traced stretch while the host was inside
``nr.scene`` spans: the pre-raster ops (camera, lighting, gather)."""

from benchmark import spans


def read(rec):
    return spans.idle_ms_per_call(rec, 'scene')
