"""Training throughput: batch x the forward + backward steps completed in
the window, over the whole window (ended by a synchronize)."""


def read(rec):
    return rec['batch'] * rec['calls'] / rec['seconds']
