"""Camera / viewpoint transforms.

Reference semantics:
  * ``look_at``  — ``neural_renderer/look_at.py:7-46``
  * ``look``     — ``neural_renderer/look.py:7-45``
  * ``perspective`` — ``neural_renderer/perspective.py:5-19`` (note the
    reference uses the literal ``3.1416``, not ``math.pi``; we reproduce that
    so NDC coordinates — and therefore golden images — match bit-for-bit).
  * ``get_points_from_angles`` — ``neural_renderer/get_points_from_angles.py``

The 3x3 rotation is written as explicit elementwise products and sums, so no
matmul precision setting (TF32) can reach it: a TF32 product would move NDC
coordinates by ~1e-3, a full pixel at 256^2.
"""

import math

import torch

from neural_renderer_torch.ops.cross import cross
from neural_renderer_torch.rasterize.config import as_tensors, place

# The reference normalizes with chainer.functions.normalize, which computes
# x / (||x|| + eps) with eps = 1e-5.  We match it exactly.
_NORMALIZE_EPS = 1e-5


def _normalize(x, dim=-1):
    sumsq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    # sqrt has an infinite derivative at 0, and autograd turns the 0 * inf
    # at a zero vector into nan — which real scanned meshes hit through
    # lighting's face normals on zero-area faces.  The double-where keeps
    # the forward bit-identical and makes the gradient at zero gy / eps,
    # exactly chainer F.normalize's analytic backward limit.
    positive = sumsq > 0
    safe = torch.where(positive, sumsq, torch.ones_like(sumsq))
    norm = torch.where(positive, torch.sqrt(safe), torch.zeros_like(sumsq))
    return x / (norm + _NORMALIZE_EPS)


def _rotate(vertices, eye, r_rows):
    """``(v - eye) @ R^T`` with R's rows ``r_rows`` ([bs, 3] each), written
    out elementwise (reference look_at.py:43-44)."""
    v = vertices - eye[:, None, :]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    out = []
    for r in r_rows:
        out.append(v0 * r[:, None, 0] + v1 * r[:, None, 1]
                   + v2 * r[:, None, 2])
    return torch.stack(out, dim=-1)


def _check_vertices(vertices):
    if vertices.ndim != 3:
        raise ValueError(f'vertices must be [bs, nv, 3]; got '
                         f'{tuple(vertices.shape)}')


def look_at(vertices, eye, at=None, up=None):
    """'Look at' transform of vertices toward ``at`` (default origin).

    vertices: ``[bs, nv, 3]`` world-space. Returns camera-space ``[bs, nv, 3]``.
    Rotation rows are (x_axis, y_axis, z_axis) built from two cross products
    (reference ``look_at.py:30-35``).
    """
    _check_vertices(vertices)
    bs = vertices.shape[0]
    dev = vertices.device
    if at is None:
        at = [0.0, 0.0, 0.0]
    if up is None:
        up = [0.0, 1.0, 0.0]
    # [3] (broadcast over the batch) or [bs, 3] each
    eye = place(eye, dev, site='look_at.eye').expand(bs, 3)
    at = place(at, dev, site='look_at.at').expand(bs, 3)
    up = place(up, dev, site='look_at.up').expand(bs, 3)

    z_axis = _normalize(at - eye)
    x_axis = _normalize(cross(up, z_axis))
    y_axis = _normalize(cross(z_axis, x_axis))
    return _rotate(vertices, eye, (x_axis, y_axis, z_axis))


def look(vertices, eye, direction=None, up=None):
    """Camera transform oriented by a view ``direction`` instead of a target.

    Reference ``look.py:7-45``.
    """
    _check_vertices(vertices)
    bs = vertices.shape[0]
    dev = vertices.device
    if direction is None:
        direction = [0.0, 0.0, 1.0]
    if up is None:
        up = [0.0, 1.0, 0.0]
    eye = place(eye, dev, site='look.eye').expand(bs, 3)
    direction = place(direction, dev, site='look.direction').expand(bs, 3)
    up = place(up, dev, site='look.up').expand(bs, 3)

    z_axis = _normalize(direction)
    x_axis = _normalize(cross(up, z_axis))
    y_axis = _normalize(cross(z_axis, x_axis))
    return _rotate(vertices, eye, (x_axis, y_axis, z_axis))


def perspective(vertices, angle=30.0):
    """Pinhole perspective divide: x' = x / (z tan(angle)), z preserved.

    Reference ``perspective.py:5-19``: angle in degrees, converted with the
    literal 3.1416 (reproduced deliberately — golden-image parity).
    """
    _check_vertices(vertices)
    angle = place(angle, vertices.device, site='perspective.angle')
    angle = angle / 180.0 * 3.1416
    width = torch.tan(angle)
    # broadcast over [bs, nv]
    width = width.reshape(-1, 1).expand(vertices.shape[:2])
    z = vertices[:, :, 2]
    x = vertices[:, :, 0] / z / width
    y = vertices[:, :, 1] / z / width
    return torch.stack([x, y, z], dim=2)


def get_points_from_angles(distance, elevation, azimuth, degrees=True,
                           device=None):
    """Spherical -> Cartesian eye position.

    Returns ``(d cosE sinA, d sinE, -d cosE cosA)``
    (reference ``get_points_from_angles.py:11-14``).  Python floats in, tuple
    of floats out (matching the reference's scalar branch); tensor or array
    inputs get the differentiable tensor branch stacked as ``[..., 3]``, on
    the tensor inputs' device, else on ``device`` (the card by default,
    ``config.as_tensors``).
    """
    if isinstance(distance, (float, int)) and isinstance(elevation, (float, int)) \
            and isinstance(azimuth, (float, int)):
        if degrees:
            elevation = math.radians(elevation)
            azimuth = math.radians(azimuth)
        return (
            distance * math.cos(elevation) * math.sin(azimuth),
            distance * math.sin(elevation),
            -distance * math.cos(elevation) * math.cos(azimuth),
        )
    distance, elevation, azimuth = as_tensors(
        [distance, elevation, azimuth], torch.float32, device)
    if degrees:
        elevation = torch.deg2rad(elevation)
        azimuth = torch.deg2rad(azimuth)
    return torch.stack([
        distance * torch.cos(elevation) * torch.sin(azimuth),
        distance * torch.sin(elevation),
        -distance * torch.cos(elevation) * torch.cos(azimuth),
    ], dim=-1)
