"""Device operations (kernels, copies, sets) per training step in the traced
stretch: each is a launch or a copy the host pays for."""

from benchmark import trace


def read(rec):
    return trace.device_ops_per_call(rec)
