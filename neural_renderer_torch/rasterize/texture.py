"""Per-face texture-cube sampling (K4) and its exact gradient (K6).

The reference samples each covered pixel's color by perspective-correcting
its barycentric weights into the face's ``ts^3`` texture cube and blending
the 8 surrounding corners trilinearly (``rasterize.py:361-438``).  This is
the plain PyTorch version; the CUDA forward kernel (``forward_cuda``) fuses
the same arithmetic for ``ts <= 4``.

The gradient (reference ``rasterize.py:750-792``, an atomicAdd scatter) is
recomputed from the saved maps.  For ``ts <= 4`` the per-face reduction
(``backward_cuda.face_reduce``) sums per-pixel *factors*
(``texture_cell_factors``) expanded to the ``ts^3 * 3`` cell columns
(``texture_channels_cells`` is the plain expansion); on the card its
kernel builds the factors itself from the maps, covered pixels only, and
these functions are its plain version.  Larger cubes take the 8-corner
scatter ``grad_textures``, as the JAX package does, summed in a fixed
order on the card (``ops/segments.py``).

Deliberate fix vs the reference: K4 reads the winning face's vertex depths
from batch 0 for every batch element (``rasterize.py:389`` indexes
``faces[face_index * 9]`` without the ``bn * nf`` offset — latent bug,
invisible in the reference's tests because they use spatially-uniform
textures).  We read ``faces[bn, face_index]`` correctly.
"""

import math

import torch

from neural_renderer_torch import tracing
from neural_renderer_torch.ops import segments
from neural_renderer_torch.rasterize.config import on_card


def _texture_index_float(settings, z, weight_map, depth_map,
                         texture_size):
    """Perspective-corrected texture coords tif [bs,is,is,3]
    (rasterize.py:398-404).  z: the winner's vertex depths [bs,is,is,3]."""
    ts = texture_size
    tif = weight_map * (ts - 1) * (depth_map[..., None] / z)
    tif = torch.clamp(tif, min=0.0)
    tif = torch.clamp(tif, max=ts - 1 - settings.eps)
    return tif


def _corner(tif, lo, pn, ts):
    """(weight [bs,is,is], flat cube index [bs,is,is]) of corner pn."""
    frac = tif - lo.to(torch.float32)
    w = 1.0
    ii = []
    for k in range(3):
        if (pn >> k) % 2 == 0:
            w = w * (1.0 - frac[..., k])
            ii.append(lo[..., k])
        else:
            w = w * frac[..., k]
            ii.append(lo[..., k] + 1)
    isc = ii[0] * ts * ts + ii[1] * ts + ii[2]
    return w, isc


def sample_textures(settings, textures, face_index_map, z, weight_map,
                    depth_map):
    """Forward texture sampling (K4): returns rgb_map [bs, is, is, 3].

    Uncovered pixels are 0 (the background composite happens in core).
    """
    bs, nf, ts = textures.shape[0], textures.shape[1], textures.shape[2]
    is_ = settings.image_size
    covered = face_index_map >= 0
    fidx = face_index_map.clamp(0, nf - 1).long()

    tif = _texture_index_float(settings, z, weight_map, depth_map, ts)
    # trunc == floor for tif >= 0; covered pixels have lo <= ts-2 already
    # (tif <= ts-1-eps), the clamp only keeps uncovered garbage in bounds
    lo = tif.to(torch.int64).clamp(0, ts - 2)

    n_cells = ts * ts * ts
    tex_flat = textures.reshape(bs, nf * n_cells, 3)
    rgb = torch.zeros((bs, is_, is_, 3), dtype=torch.float32,
                      device=textures.device)
    for pn in range(8):
        w, isc = _corner(tif, lo, pn, ts)
        gidx = (fidx * n_cells + isc).reshape(bs, -1, 1).expand(-1, -1, 3)
        texel = torch.gather(tex_flat, 1, gidx).reshape(bs, is_, is_, 3)
        rgb = rgb + w[..., None] * texel
    return torch.where(covered[..., None], rgb, torch.zeros_like(rgb))


def _axis_hats(settings, z, weight_map, depth_map, ts):
    """Per-axis trilinear hat vectors: for k = 0, 1, 2 a list of ts maps
    ``[bs, is, is]``, nonzero only at lo_k (``1 - frac``) and lo_k + 1
    (``frac``).  Uncovered pixels hold NaN (their tif is ``0 * far / 0``)."""
    tif = _texture_index_float(settings, z, weight_map, depth_map, ts)
    lo = tif.to(torch.int32)            # trunc == floor for tif >= 0
    frac = tif - lo.to(torch.float32)
    zero = torch.zeros_like(frac[..., 0])

    def axis_vec(k):
        lk, fk = lo[..., k], frac[..., k]
        return [torch.where(lk == j, 1.0 - fk, zero)
                + torch.where(lk + 1 == j, fk, zero) for j in range(ts)]

    return axis_vec(0), axis_vec(1), axis_vec(2)


def texture_cell_factors(settings, face_index_map, z, weight_map,
                         depth_map, grad_rgb, ts):
    """K6 per-pixel factor channels ``[bs, ts^2 + ts + 3, is, is]``: the ts^2
    paired axis-0/1 hat products ``p01``, the ts axis-2 hats ``a2`` and the
    grad_rgb channels (``grad_rgb`` is ``[bs, 3, is, is]``).

    Cell ``(i01 * ts + c2) * 3 + c`` of a pixel's gradient row is
    ``(p01[i01] * a2[c2]) * g[c]`` (``texture_channels_cells``).  Every
    channel is zeroed at uncovered pixels, where tif is NaN."""
    covered = face_index_map >= 0
    a0, a1, a2 = _axis_hats(settings, z, weight_map, depth_map, ts)
    zero = torch.zeros_like(a2[0])
    chans = [x0 * x1 for x0 in a0 for x1 in a1] + a2
    chans += [grad_rgb[:, c] for c in range(3)]
    return torch.stack([torch.where(covered, x, zero) for x in chans], dim=1)


def texture_channels_cells(factors, ts):
    """Expand factor channels ``[bs, ts^2 + ts + 3, is, is]`` into the
    cell-resolved rows ``[bs, ts^3 * 3, is, is]``: channel
    ``(i01 * ts + c2) * 3 + c`` holds ``(p01[i01] * a2[c2]) * g[c]``, the
    pixel's trilinear weight of cube cell ``i01 * ts + c2`` times
    ``grad_rgb_c`` (the JAX package's ``texture_channels_cells``, and at
    ts 2 its ``texture_channels_ts2``, in the same multiply order)."""
    n01 = ts * ts
    p01 = factors[:, :n01]
    a2 = factors[:, n01:n01 + ts]
    g = factors[:, n01 + ts:]
    w = p01[:, :, None] * a2[:, None, :]             # [bs, n01, ts, is, is]
    cells = w[:, :, :, None] * g[:, None, None]      # [.., ts, 3, is, is]
    return cells.reshape(factors.shape[0], n01 * ts * 3, *factors.shape[2:])


def corner_rows(settings, face_index_map, z, weight_map, depth_map,
                grad_rgb_map, texture_shape, uncovered):
    """The 8-corner scatter's rows, corner-major: (cell ids
    ``[8 * bs * is * is]`` int64, rows ``[8 * bs * is * is, 3]``), where
    corner ``pn`` of a covered pixel adds ``w_pn * grad_rgb[pixel]`` to
    cell ``(b * nf + f) * ts^3 + isc`` of the flattened texture gradient.
    An uncovered pixel's rows are zeros with cell id ``uncovered``."""
    bs, nf, ts = texture_shape[0], texture_shape[1], texture_shape[2]
    covered = face_index_map >= 0
    fidx = face_index_map.clamp(0, nf - 1).long()
    n_cells = ts * ts * ts
    tif = _texture_index_float(settings, z, weight_map, depth_map, ts)
    lo = tif.to(torch.int64)
    boffs = (torch.arange(bs, device=fidx.device) * (nf * n_cells))[
        :, None, None]
    zero = torch.zeros_like(grad_rgb_map)
    off = torch.full_like(fidx, uncovered)
    segs, contribs = [], []
    for pn in range(8):
        w, isc = _corner(tif, lo, pn, ts)
        seg = torch.where(covered, fidx * n_cells + isc + boffs, off)
        contrib = torch.where(covered[..., None], w[..., None] * grad_rgb_map,
                              zero)
        segs.append(seg.reshape(-1))
        contribs.append(contrib.reshape(-1, 3))
    return torch.cat(segs), torch.cat(contribs)


def grad_textures(settings, face_index_map, z, weight_map, depth_map,
                  grad_rgb_map, texture_shape):
    """K6 by the 8-corner scatter, for any ts (the backward uses it for
    ts > 4): ``grad[b, f, isc] += w_pn * grad_rgb[pixel]`` for the 8 corners
    of every covered pixel, over ``bs * nf * ts^3`` cells
    (``corner_rows``).  grad_rgb_map: ``[bs, is, is, 3]``.  Returns
    ``texture_shape``.

    A CPU tensor takes the plain version: ``index_add_`` of the rows in
    order, uncovered pixels' zeros onto cell 0.  A CUDA tensor sorts the
    rows by cell, stable, and sums each cell's rows in that order with the
    segmented-sum kernel (``ops/segments.py``): the same order, and no
    float atomics, so every run gives the same bits.  Uncovered pixels'
    rows get the id past the last cell, where the sum never reads.  At
    bs 32, 512^2 and ts 8 that is 67 M rows: 0.8 GB of rows and 1.1 GB of
    sort keys and permutation (the sort's time is in PERF.md).

    On the card it counts one ``k6.scatter``, the rows handed to the sort
    (``work.k6_scatter_rows``, ``8 * bs * is^2``) and the cells
    (``work.k6_scatter_cells``, ``bs * nf * ts^3``): shapes the host
    knows."""
    nseg = math.prod(texture_shape[:-1])
    if on_card(face_index_map):
        ids, rows = corner_rows(settings, face_index_map, z, weight_map,
                                depth_map, grad_rgb_map, texture_shape, nseg)
        tracing.COUNTS['k6.scatter'] += 1
        tracing.COUNTS['work.k6_scatter_rows'] += ids.shape[0]
        tracing.COUNTS['work.k6_scatter_cells'] += nseg
        perm, offsets = segments.sort_segments(ids, nseg)
        flat = segments.segment_sum(rows, perm, offsets)
    else:
        ids, rows = corner_rows(settings, face_index_map, z, weight_map,
                                depth_map, grad_rgb_map, texture_shape, 0)
        flat = torch.zeros((nseg, 3), dtype=torch.float32,
                           device=face_index_map.device).index_add_(
                               0, ids, rows)
    return flat.reshape(texture_shape)
