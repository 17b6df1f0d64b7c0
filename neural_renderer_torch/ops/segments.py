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
``tracing.COUNTS['launch.segment_sum']`` counts kernel launches.
"""

import torch

from neural_renderer_torch import _build
from neural_renderer_torch.rasterize.config import on_card


def sort_segments(ids, nseg):
    """(perm, offsets) of segment ids ``ids`` (any shape, int): ``perm``
    int64 orders the flattened ids ascending, stable; ``offsets`` int64
    ``[nseg + 1]`` delimits segments ``0 .. nseg - 1`` in that order.  Ids
    at or beyond ``nseg`` fall after ``offsets[nseg]``, so their rows are
    never summed.  Both are contiguous and on ``ids``' device, as
    ``segment_sum`` takes them without checking again."""
    ids = ids.reshape(-1)
    keys, perm = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(nseg + 1, dtype=keys.dtype, device=keys.device))
    return perm, offsets


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
    in ascending ``i``.  ``perm`` and ``offsets`` come from
    ``sort_segments`` of the rows' ids, on the rows' device.
    Deterministic: every run gives the same bits."""
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[0] != perm.shape[0]
            or perm.get_device() != rows.get_device()):
        raise ValueError(
            f'rows must be float32 [n, C] on the device of perm [n] '
            f'({perm.shape[0]} on {perm.device}); got {rows.dtype} '
            f'{tuple(rows.shape)} on {rows.device}')
    if not rows.is_cuda and not on_card(rows):
        return segment_sum_plain(rows, perm, offsets)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    n, C = rows.shape
    nseg = offsets.shape[0] - 1
    out = rows.new_empty((nseg, C))
    _build.launch(_build.library('segment_sum'), 'segment_sum',
                  rows.get_device(), rows.data_ptr(), perm.data_ptr(),
                  offsets.data_ptr(), n, nseg, C, out.data_ptr())
    return out
