"""Segmented row sums: the deterministic scatter-add of the port.

``segment_sum(rows, perm, offsets)`` sums the rows of each segment, in
ascending row order, where ``perm`` orders the rows by segment id (stable)
and ``offsets`` delimits the segments in that order (``sort_segments``
makes both from the ids).  It carries the vertex gradient of
``vertices_to_faces`` and the texture gradient of cubes above ts 4
(``texture.grad_textures``) on the card, where ``index_add_`` and
``index_put_`` add with float atomics in an order that changes from run to
run.

A CUDA tensor runs the hand-written kernel ``csrc/segment_sum.cu`` (or
raises); a CPU tensor runs ``segment_sum_plain``, an ``index_add_``.
``LAUNCHES`` counts kernel launches.
"""

import ctypes
import functools

import torch

from neural_renderer_torch import _build
from neural_renderer_torch.rasterize.config import on_card

LAUNCHES = {'segment_sum': 0}


@functools.cache
def _kernel():
    """The kernel's library, built at first use."""
    lib = _build.load('segment_sum')
    ptr = ctypes.c_void_p
    lib.nr_segment_sum.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                   ctypes.c_int, ptr, ptr]
    lib.nr_segment_sum.restype = ctypes.c_int
    lib.nr_error_string.argtypes = [ctypes.c_int]
    lib.nr_error_string.restype = ctypes.c_char_p
    return lib


def sort_segments(ids, nseg):
    """(perm, offsets) of segment ids ``ids`` (any shape, int): ``perm``
    int64 orders the flattened ids ascending, stable; ``offsets`` int64
    ``[nseg + 1]`` delimits segments ``0 .. nseg - 1`` in that order.  Ids
    at or beyond ``nseg`` fall after ``offsets[nseg]``, so their rows are
    never summed."""
    ids = ids.reshape(-1)
    keys, perm = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(nseg + 1, dtype=keys.dtype, device=keys.device))
    return perm, offsets


def _check(rows, perm, offsets):
    if rows.dtype != torch.float32 or rows.ndim != 2:
        raise ValueError('rows must be float32 [n, C]; got '
                         f'{rows.dtype} {tuple(rows.shape)}')
    for name, t, n in (('perm', perm, rows.shape[0]),
                       ('offsets', offsets, None)):
        if (t.dtype != torch.int64 or t.ndim != 1
                or (n is not None and t.shape[0] != n)
                or t.device != rows.device):
            raise ValueError(f'{name} must be int64 [{n or "nseg + 1"}] on '
                             f'{rows.device}; got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    if offsets.shape[0] < 1:
        raise ValueError('offsets needs nseg + 1 >= 1 entries')


def segment_sum_plain(rows, perm, offsets):
    """The plain PyTorch version of ``segment_sum``: ``index_add_`` of the
    permuted rows onto their segments, in order."""
    nseg = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=rows.device), counts)
    used = perm[int(offsets[0]):int(offsets[-1])]
    out = torch.zeros((nseg, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, seg, rows[used])


def segment_sum(rows, perm, offsets):
    """``[nseg, C]`` sums of ``rows [n, C]`` float32 per segment: segment
    ``s`` sums ``rows[perm[i]]`` for ``offsets[s] <= i < offsets[s + 1]``,
    in ascending ``i`` (``sort_segments``).  Deterministic: every run gives
    the same bits."""
    _check(rows, perm, offsets)
    if not on_card(rows):
        return segment_sum_plain(rows, perm, offsets)
    nseg = offsets.shape[0] - 1
    rows = rows.contiguous()
    perm, offsets = perm.contiguous(), offsets.contiguous()
    out = torch.empty((nseg, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    lib = _kernel()
    with torch.cuda.device(rows.device):
        rc = lib.nr_segment_sum(
            rows.data_ptr(), perm.data_ptr(), offsets.data_ptr(), nseg,
            rows.shape[1], out.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    _build.raise_on_error(lib, rc, 'segment_sum')
    LAUNCHES['segment_sum'] += 1
    return out
