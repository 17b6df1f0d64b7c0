"""Gather per-face vertex coordinates.

Reference ``neural_renderer/vertices_to_faces.py:4-21``: flattens the batch
and fancy-indexes.  Autograd turns the gather into an ``index_add`` over the
vertices; the JAX package's incidence-matmul gradient is a TPU scatter
workaround and has no counterpart here.
"""

import torch


def vertices_to_faces(vertices, faces):
    """``[bs, nv, 3]`` vertices + ``[bs, nf, 3]`` int faces -> ``[bs, nf, 3, 3]``.

    ``out[b, f, k] = vertices[b, faces[b, f, k]]``.
    """
    if vertices.ndim != 3 or faces.ndim != 3:
        raise ValueError('vertices must be [bs, nv, 3] and faces [bs, nf, 3]')
    if vertices.shape[0] != faces.shape[0] or vertices.shape[2] != 3 \
            or faces.shape[2] != 3:
        raise ValueError(f'vertices {tuple(vertices.shape)} and faces '
                         f'{tuple(faces.shape)} do not match')
    bs, nv = vertices.shape[:2]
    nf = faces.shape[1]
    faces = faces.to(device=vertices.device, dtype=torch.int64)
    # batched gather with per-batch offsets into the flattened vertex table
    # (the reference's layout trick, vertices_to_faces.py:19-21)
    offsets = (torch.arange(bs, device=vertices.device) * nv)[:, None, None]
    flat_idx = (faces + offsets).reshape(-1)
    return vertices.reshape(bs * nv, 3)[flat_idx].reshape(bs, nf, 3, 3)
