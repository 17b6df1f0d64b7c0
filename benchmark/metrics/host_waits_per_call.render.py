"""Host waits per call in the traced stretch: pageable
host-to-device copies on the device (the host waits for each) plus the
host's cuda*Synchronize calls, not counting the harness's own
synchronize."""

from benchmark import trace


def read(rec):
    return trace.host_waits_per_call(rec)
