"""Host waits per training step in the traced stretch, as the program
counts them at the sites that make them: its ``nr.wait.<kind>.<site>``
spans, one for each copy of host data to the card and each host read of a
value on the card."""

from benchmark import spans


def read(rec):
    return spans.waits_per_call(rec)
