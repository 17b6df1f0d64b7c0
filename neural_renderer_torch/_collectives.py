"""The collective the port's parallel paths use (``parallel.py``, the
face-group merge of ``rasterize/core.py`` and the vertex gradient of
``ops/vertices_to_faces.py``).

``all_reduce`` reduces a tensor in place over a ``torch.distributed``
process group.  A gloo group takes a CUDA tensor through the host, a copy
each way made here rather than inside the backend, so the same code runs
on gloo (the CPU tests, ranks sharing one card) and on NCCL.
"""

import torch.distributed as dist


def all_reduce(t, op, group):
    """``t`` reduced in place by ``op`` (``dist.ReduceOp``) over
    ``group``; returns ``t``."""
    if t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t
