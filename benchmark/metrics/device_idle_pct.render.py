"""Share of the traced stretch (its calls and the synchronize that ends
them) in which no operation ran on the device, in %."""

from benchmark import trace


def read(rec):
    return trace.idle_pct(rec)
