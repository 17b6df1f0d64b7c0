"""Shared rasterization geometry: pixel mappings, barycentric matrices, culling.

Conventions (identical to the reference CUDA kernels):
  * NDC vertex (x, y) in [-1, 1] maps to *pixel-space* coordinate
    ``p = 0.5 * (x * is + is - 1)`` (reference ``rasterize.py:258``);
  * the NDC position of integer pixel (xi, yi)'s center is
    ``xp = (2*xi + 1 - is) / is`` (reference ``rasterize.py:291-292``) —
    note this maps exactly onto pixel-space coordinate ``xi``;
  * a face is *backfacing* (skipped) when
    ``(y2-y0)*(x1-x0) < (y1-y0)*(x2-x0)`` in NDC
    (reference ``rasterize.py:252-253``);
  * ``face_inv`` is the adjugate/determinant of the pixel-space 3x3
    ``[[x0,y0,1],[x1,y1,1],[x2,y2,1]]`` so that barycentric weights are
    ``w_k = face_inv[k] . (xi, yi, 1)`` (reference ``rasterize.py:261-269``).

faces tensors are ``[..., 3 (vertices), 3 (xyz)]`` in NDC throughout.  Every
expression keeps the operand order of the reference (and of the JAX
package): the CUDA kernel repeats it operation for operation, so the two
agree bit for bit.
"""

import torch


def to_pixel_coords(v, image_size):
    """NDC coordinate -> pixel-space coordinate (reference rasterize.py:258)."""
    return 0.5 * (v * image_size + image_size - 1.0)


def pixel_centers(image_size, device=None, dtype=torch.float32):
    """NDC coordinates of pixel centers along one axis: [(2i+1-is)/is]."""
    i = torch.arange(image_size, device=device, dtype=dtype)
    return (2.0 * i + 1.0 - image_size) / image_size


def is_frontface(faces):
    """Front-facing mask ``[...]`` from NDC faces ``[..., 3, 3]``.

    The reference *skips* a face when
    ``(y2-y0)*(x1-x0) < (y1-y0)*(x2-x0)`` (rasterize.py:252-253); we return
    the complement.  Degenerate (zero-area) faces compare ``0 < 0`` -> False,
    so they count as front-facing, exactly like the reference.
    """
    x0, y0 = faces[..., 0, 0], faces[..., 0, 1]
    x1, y1 = faces[..., 1, 0], faces[..., 1, 1]
    x2, y2 = faces[..., 2, 0], faces[..., 2, 1]
    return torch.logical_not((y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0))


def face_inv_matrix(px, py):
    """Barycentric matrix from pixel-space vertex coords.

    px, py: ``[..., 3]`` pixel-space x / y per vertex.
    Returns ``[..., 3, 3]`` such that ``w_k = out[k] . (xi, yi, 1)``.
    Formula and operand order follow reference rasterize.py:261-269 exactly
    (including producing inf/nan for degenerate faces — those faces never
    pass the inside test / z test downstream, matching CUDA behavior).
    """
    p0x, p1x, p2x = px[..., 0], px[..., 1], px[..., 2]
    p0y, p1y, p2y = py[..., 0], py[..., 1], py[..., 2]
    denom = (p2x * (p0y - p1y) + p0x * (p1y - p2y) + p1x * (p2y - p0y))
    rows = torch.stack([
        torch.stack([p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y], dim=-1),
        torch.stack([p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y], dim=-1),
        torch.stack([p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y], dim=-1),
    ], dim=-2)
    return rows / denom[..., None, None]


def inside_tests(xp, yp, faces):
    """Strict inside mask for NDC pixel-center positions against NDC faces.

    xp, yp broadcast against faces' batch dims; faces ``[..., 3, 3]``.
    A pixel is *outside* when any of the 3 edge tests fires
    (reference rasterize.py:310-312, operand order preserved).
    """
    x0, y0 = faces[..., 0, 0], faces[..., 0, 1]
    x1, y1 = faces[..., 1, 0], faces[..., 1, 1]
    x2, y2 = faces[..., 2, 0], faces[..., 2, 1]
    t0 = (yp - y0) * (x1 - x0) < (xp - x0) * (y1 - y0)
    t1 = (yp - y1) * (x2 - x1) < (xp - x1) * (y2 - y1)
    t2 = (yp - y2) * (x0 - x2) < (xp - x2) * (y0 - y2)
    return torch.logical_not(t0 | t1 | t2)


def clamp_renormalize_weights(w):
    """Clamp each weight to [0,1] then renormalize to sum 1.

    Reference rasterize.py:322-327 (clamp *then* renormalize — order matters
    for pixels near edges).  0/0 -> nan propagates, and downstream z tests
    reject nan, matching the CUDA kernel's net behavior.  The sum is written
    out as ``(w0 + w1) + w2`` so the kernel can repeat it exactly.
    """
    w = torch.clamp(w, 0.0, 1.0)
    wsum = w[..., 0:1] + w[..., 1:2] + w[..., 2:3]
    return w / wsum


def perspective_correct_depth(w, z):
    """``zp = 1 / sum_k(w_k / z_k)`` (reference rasterize.py:330)."""
    q = w / z
    return 1.0 / (q[..., 0] + q[..., 1] + q[..., 2])
