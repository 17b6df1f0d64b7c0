"""torch.cuda.max_memory_allocated() over the window (reset at its
start), in GiB: what bounds the batch or views a user can fit."""


def read(rec):
    return rec['peak_bytes'] / 2 ** 30 if rec['peak_bytes'] else None
