"""Gather per-face vertex coordinates, with a deterministic backward.

Reference ``neural_renderer/vertices_to_faces.py:4-21``: flattens the batch
and fancy-indexes.  The gradient sums each vertex's incident (face, slot)
rows.  On a CUDA tensor autograd's own scatter (``index_put_`` with
accumulate) adds them with float atomics in an order that changes from run
to run, so the backward here sums them with the segmented-sum kernel
(``ops/segments.py``) in ascending row order.  On a CPU tensor the backward
is the plain ``index_add_``.  The JAX package is deterministic too (an
incidence matmul or a scatter,
``neural_renderer_tpu/ops/vertices_to_faces.py:57-93``).

The rows' sort by vertex depends on the face list alone, and a ``Mesh``
hands the same face tensor every step, so the sort is kept per caller face
tensor: ``_SORTS`` holds the last few, keyed by the tensor's address,
shape, strides, dtype, device and version counter (which every in-place
write to its storage bumps), beside the tensor itself, so that its memory
cannot pass to another tensor while the entry lives.  Inference tensors
carry no version counter and are sorted anew.
"""

import collections

import torch
import torch.distributed as dist

from neural_renderer_torch import tracing
from neural_renderer_torch._collectives import all_reduce
from neural_renderer_torch.ops import segments
from neural_renderer_torch.rasterize.config import on_card, place

# face tensors whose sort is kept (a few meshes or renderers in turn)
_SORTS_KEPT = 4
# key -> (the caller's face tensor, (perm, offsets))
_SORTS = collections.OrderedDict()


def _sort(faces, flat, nseg, extra):
    """(perm, offsets) of the flat gather indices ``flat`` made from the
    caller's face tensor ``faces``: kept across calls unless ``faces`` is
    an inference tensor."""
    if faces.is_inference():
        return segments.sort_segments(flat, nseg)
    key = (faces.data_ptr(), tuple(faces.shape), faces.stride(), faces.dtype,
           faces.device, faces._version, nseg, extra)
    entry = _SORTS.get(key)
    if entry is None:
        entry = _SORTS[key] = (faces, segments.sort_segments(flat, nseg))
        if len(_SORTS) > _SORTS_KEPT:
            _SORTS.popitem(last=False)
    else:
        _SORTS.move_to_end(key)
    return entry[1]


def fill_back_faces(faces):
    """Each face followed, after all of them, by its back-to-front copy:
    ``[bs, nf, 3]`` -> ``[bs, 2 nf, 3]`` (reference renderer.py:37,57,77)."""
    return torch.cat([faces, torch.flip(faces, dims=[2])], dim=1)


def _flat_index(faces, nv):
    bs = faces.shape[0]
    # batched gather with per-batch offsets into the flattened vertex table
    # (the reference's layout trick, vertices_to_faces.py:19-21)
    offsets = (torch.arange(bs, device=faces.device) * nv)[:, None, None]
    return (faces + offsets).reshape(-1)


class _Gather(torch.autograd.Function):
    """vertices [bs, nv, 3], faces [bs, nf, 3] int -> [bs, nf', 3, 3]
    (nf' = 2 nf with ``fill_back``)."""

    @staticmethod
    def forward(ctx, vertices, faces, group, fill_back):
        bs, nv = vertices.shape[:2]
        f = place(faces, vertices.device, torch.int64,
                  site='vertices_to_faces.faces')
        if fill_back:
            f = fill_back_faces(f)
        flat = _flat_index(f, nv)
        ctx.faces, ctx.nv, ctx.group, ctx.fill_back = (faces, nv, group,
                                                        fill_back)
        ctx.save_for_backward(flat)
        out = vertices.reshape(bs * nv, 3).index_select(0, flat)
        return out.reshape(bs, f.shape[1], 3, 3)

    @staticmethod
    def backward(ctx, g):
        flat, = ctx.saved_tensors
        bs, nv = ctx.faces.shape[0], ctx.nv
        rows = g.reshape(-1, 3)
        with tracing.span('backward'), tracing.span('backward.scatter'):
            if not on_card(rows):
                gv = torch.zeros((bs * nv, 3), dtype=g.dtype,
                                 device=g.device)
                gv.index_add_(0, flat, rows)
            else:
                perm, offsets = _sort(ctx.faces, flat, bs * nv,
                                      (ctx.fill_back, rows.device))
                gv = segments.segment_sum(rows, perm, offsets)
            if ctx.group is not None:
                all_reduce(gv, dist.ReduceOp.SUM, ctx.group)
        return gv.reshape(bs, nv, 3), None, None, None


def vertices_to_faces(vertices, faces, group=None, fill_back=False):
    """``[bs, nv, 3]`` vertices + ``[bs, nf, 3]`` int faces -> ``[bs, nf, 3, 3]``.

    ``out[b, f, k] = vertices[b, faces[b, f, k]]``.  ``group``: the
    ``torch.distributed`` process group over which ``faces`` is sharded
    (face-axis model parallelism): each rank's vertex gradient is then the
    sum over the group, as the JAX package's psum makes it
    (``neural_renderer_tpu/ops/vertices_to_faces.py:94-105``).
    ``fill_back``: gather for ``fill_back_faces(faces)``,
    ``[bs, 2 nf, 3, 3]``, the list the ``Renderer`` draws.
    """
    if vertices.ndim != 3 or faces.ndim != 3:
        raise ValueError('vertices must be [bs, nv, 3] and faces [bs, nf, 3]')
    if vertices.shape[0] != faces.shape[0] or vertices.shape[2] != 3 \
            or faces.shape[2] != 3:
        raise ValueError(f'vertices {tuple(vertices.shape)} and faces '
                         f'{tuple(faces.shape)} do not match')
    return _Gather.apply(vertices, faces, group, fill_back)
