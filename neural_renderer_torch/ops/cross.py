"""Batched 3-vector cross product (reference ``neural_renderer/cross.py``).

Written out component by component, in the operand order of ``jnp.cross``,
so the JAX package and this port round alike; autograd gives the reference's
backward ``ga = b x gc, gb = gc x a`` (``cross.py:50-55``).
"""

import torch

from neural_renderer_torch.rasterize.config import as_tensors


def cross(a, b, device=None):
    """Row-wise cross product of two ``[..., 3]`` (broadcastable) tensors.
    A non-tensor operand lands beside the tensor one, or on ``device`` (the
    card by default, ``config.as_tensors``)."""
    a, b = as_tensors([a, b], device=device)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)
