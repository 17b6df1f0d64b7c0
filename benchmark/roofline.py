"""The work behind the benchmark's roofline shares, counted from what the
cell's inputs need and never from how the program does it.

A share is the least time the card could take over the time the kernels
took: the least time is the larger of the bytes over the memory rate and
the float32 operations over the float32 rate (NVIDIA H100 SXM data sheet,
at its 700 W limit), each input byte read once and each output byte
written once.  The counts here read the plain reference's own face
coordinates and face-index map; they call nothing of the program.

Forward (``forward_work``): the rasterizer's input faces (NDC, after
fill_back) and lit texture cubes read once, and per raster pixel the face
index (4 bytes) and, where drawn, rgb (12) and depth (4) written once: what
the outputs of a render need from the raster.  Operations: 15 per (pixel,
face) pair of each front-facing face's bounding box (three edge tests of
two differences, two products and a compare).

Out-sweep (``outsweep_work``): the face-index map and the faces' x, y read
once, the value and gradient planes read on every line that holds an
active crossing (rgb 24 bytes a pixel, alpha 8), the per-face vertex
gradient written once.  Operations per swept position: the value
difference times the gradient (rgb 8, alpha 2, both 11), the offset from
the crossing (1), and per term its product, the eps step, the division and
the add (2 x 4).
"""

import torch

from benchmark.reference import raster

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4
PAIR_OPS = 15


def least_seconds(nbytes, ops):
    """(least seconds, 'bytes' or 'operations', whichever bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _weighted(per_element, weights):
    """The sum over batch elements of ``per_element`` ``[bs]``, element
    ``b`` counted ``weights[b]`` times (once each without weights)."""
    per_element = per_element.double()
    if weights is not None:
        per_element = per_element * weights.to(per_element)
    return int(per_element.sum())


def count(weights, bs):
    """The batch elements that ``weights`` stand for."""
    return bs if weights is None else int(weights.sum())


def box_pairs(faces_ndc, is_, weights=None):
    """(pixel, face) pairs: for each front-facing face with finite
    coordinates, the pixel centres inside the bounding box of its
    pixel-space vertices, clipped to the image.  ``faces_ndc`` ``[bs, nf,
    3, 3]``, batch element ``b`` counted ``weights[b]`` times; returns an
    int."""
    x, y = faces_ndc[..., 0], faces_ndc[..., 1]

    def span(p):
        p = raster.to_pixel(p, is_)
        lo = torch.clamp(torch.ceil(p.amin(-1)), min=0.0)
        hi = torch.clamp(torch.floor(p.amax(-1)), max=is_ - 1.0)
        return torch.clamp(hi - lo + 1.0, min=0.0), torch.isfinite(p).all(-1)

    nx, fx = span(x)
    ny, fy = span(y)
    keep = raster.is_front(faces_ndc) & fx & fy
    return _weighted(torch.where(keep, nx * ny, torch.zeros_like(nx)).sum(-1),
                     weights)


def forward_work(faces_ndc, texture_size, is_, outputs, weights=None):
    """{'bytes', 'ops', 'pairs'} of one raster of ``faces_ndc`` at
    ``is_``, drawing ``outputs`` ('rgb', 'alpha', 'depth'); batch element
    ``b`` counted ``weights[b]`` times."""
    nf = faces_ndc.shape[1]
    bs = count(weights, faces_ndc.shape[0])
    nbytes = F32 * bs * nf * 9
    per_pixel = 4
    if 'rgb' in outputs:
        nbytes += F32 * bs * nf * texture_size ** 3 * 3
        per_pixel += 12
    if 'depth' in outputs:
        per_pixel += 4
    nbytes += per_pixel * bs * is_ * is_
    pairs = box_pairs(faces_ndc, is_, weights)
    return dict(bytes=nbytes, ops=PAIR_OPS * pairs, pairs=pairs)


def outsweep_stats(faces_ndc, fim, is_, weights=None):
    """The out-sweep's crossings on the reference's face-index map ``fim``
    ``[bs, is, is]``: {'active', 'positions', 'line_pixels'}: the active
    crossings (a covered pixel's own face edge crossing its own column or
    row, with the in-pixel on the face), the positions they sweep (from
    the out-pixel to the border), and the pixels on at least one line
    that holds an active crossing.  Batch element ``b`` is counted
    ``weights[b]`` times."""
    bs = fim.shape[0]
    s = raster.Settings(is_)
    covered = fim >= 0
    face_w = raster.winner_rows(faces_ndc, fim)
    ppx = raster.to_pixel(face_w[..., 0], is_)
    ppy = raster.to_pixel(face_w[..., 1], is_)
    yi, xi = raster._grid(bs, is_, ppx)
    lines = [torch.zeros((bs, is_), dtype=torch.bool, device=fim.device)
             for _ in range(2)]
    active = positions = 0
    for e, a in raster.EA:
        X, Y = raster._walk(ppx, ppy, e, a)
        d0, d1 = (xi, yi) if a == 0 else (yi, xi)
        cr = raster._crossing(s, X, Y, a, d0)
        act = covered & cr['valid'] & (cr['d1_in'] == d1)
        lines[a] |= act.any(dim=1 if a == 0 else 2)
        span = torch.where(cr['direction'] > 0, is_ - cr['d1_out'],
                           cr['d1_out'] + 1.0)
        active += _weighted(act.sum((1, 2)), weights)
        positions += _weighted(torch.where(act, span, 0.0).double().sum(
            (1, 2)), weights)
    cols, rows = lines[0].sum(1), lines[1].sum(1)
    line_pixels = _weighted((cols + rows) * is_ - cols * rows, weights)
    return dict(active=active, positions=positions, line_pixels=line_pixels)


def outsweep_work(faces_ndc, fim, is_, rgb, alpha, weights=None):
    """{'bytes', 'ops', ...} of the out-sweep of one raster, with the
    rgb and/or alpha terms; batch element ``b`` counted ``weights[b]``
    times."""
    nf = faces_ndc.shape[1]
    bs = count(weights, faces_ndc.shape[0])
    st = outsweep_stats(faces_ndc, fim, is_, weights)
    plane = (24 if rgb else 0) + (8 if alpha else 0)
    nbytes = (4 * bs * is_ * is_ + F32 * bs * nf * 6
              + plane * st['line_pixels'] + F32 * bs * nf * 9)
    diff = 11 if (rgb and alpha) else 8 if rgb else 2
    return dict(st, bytes=nbytes, ops=(diff + 1 + 8) * st['positions'])
