"""Rendering throughput: views x the calls completed in the window, over
the whole window (ended by a synchronize)."""


def read(rec):
    return rec['batch'] * rec['calls'] / rec['seconds']
