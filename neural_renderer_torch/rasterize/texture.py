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
scatter ``grad_textures``, as the JAX package does: on the card one
hand-written kernel (``csrc/tex_scatter.cu``) sums each face's cube from
the forward's tile lists in a fixed order, and ``corner_rows`` with one
``index_add_`` is its plain version.

Deliberate fix vs the reference: K4 reads the winning face's vertex depths
from batch 0 for every batch element (``rasterize.py:389`` indexes
``faces[face_index * 9]`` without the ``bn * nf`` offset — latent bug,
invisible in the reference's tests because they use spatially-uniform
textures).  We read ``faces[bn, face_index]`` correctly.
"""

import math

import torch

from neural_renderer_torch import _build, tracing
from neural_renderer_torch.rasterize import config
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
                  grad_rgb_map, texture_shape, bins=None):
    """K6 by the 8-corner scatter, for any ts (the backward uses it for
    ts > 4): ``grad[b, f, isc] += w_pn * grad_rgb[pixel]`` for the 8 corners
    of every covered pixel, over ``bs * nf * ts^3`` cells
    (``corner_rows``).  z, weight_map: ``[bs, is, is, 3]`` and
    grad_rgb_map ``[bs, is, is, 3]``, any strides; depth_map
    ``[bs, is, is]``.  Returns ``texture_shape``.

    A CPU tensor takes the plain version (``grad_textures_plain``).  A
    CUDA tensor launches ``csrc/tex_scatter.cu`` (``_tex_scatter``), which
    needs ``bins``, the forward's tile lists
    (``forward_shaded(...)['bins']``).  On the card it counts one
    ``k6.scatter`` and the cells it writes (``work.k6_scatter_cells``,
    ``bs * nf * ts^3``): shapes the host knows."""
    if on_card(face_index_map):
        return _tex_scatter(settings, face_index_map, z, weight_map,
                            depth_map, grad_rgb_map, texture_shape, bins)
    return grad_textures_plain(settings, face_index_map, z, weight_map,
                               depth_map, grad_rgb_map, texture_shape)


def grad_textures_plain(settings, face_index_map, z, weight_map, depth_map,
                        grad_rgb_map, texture_shape):
    """The plain PyTorch version of ``grad_textures``: ``index_add_`` of
    ``corner_rows`` in order, uncovered pixels' zeros onto cell 0."""
    nseg = math.prod(texture_shape[:-1])
    ids, rows = corner_rows(settings, face_index_map, z, weight_map,
                            depth_map, grad_rgb_map, texture_shape, 0)
    flat = torch.zeros((nseg, 3), dtype=torch.float32,
                       device=face_index_map.device).index_add_(0, ids, rows)
    return flat.reshape(texture_shape)


def _tex_scatter(settings, face_index_map, z, weight_map, depth_map,
                 grad_rgb_map, texture_shape, bins):
    """``grad_textures`` on the card: one launch of ``nr_tex_scatter``
    (three kernels), which writes every cell of a new ``texture_shape``
    tensor (no fill before it).  A face's cell sums its pixels' corner terms in the order of the
    face's tile-list rows, then pixel order within a tile: each term is
    ``corner_rows``' bit for bit, the sums another order than the plain
    ``index_add_``'s, and the same bits every run.  Cells are addressed
    with 64 bits (the cube passes 2^31 floats at bs 32, ts 16); pixels,
    faces and pairs with int32, which it checks."""
    bs, nf, ts = texture_shape[0], texture_shape[1], texture_shape[2]
    is_ = face_index_map.shape[1]
    dev = face_index_map.device
    if tuple(texture_shape) != (bs, nf, ts, ts, ts, 3) or ts < 2:
        raise ValueError('the texture scatter takes cubes [bs, nf, ts, ts, '
                         f'ts, 3] of ts >= 2; got {tuple(texture_shape)}')
    want = {'face_index_map': (face_index_map, (bs, is_, is_), torch.int32),
            'z': (z, (bs, is_, is_, 3), torch.float32),
            'weight_map': (weight_map, (bs, is_, is_, 3), torch.float32),
            'depth_map': (depth_map, (bs, is_, is_), torch.float32),
            'grad_rgb_map': (grad_rgb_map, (bs, is_, is_, 3), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != dev):
            raise ValueError(f'{name} must be {dtype} {shape} on {dev}; got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    lib = _build.library('tex_scatter')
    config.check_bins(bins, bs, nf, is_, lib.nr_tex_scatter_tile(), dev,
                      'the texture scatter')
    pairs = bins['order'].shape[0]
    # the pairs' scratch holds one word more, the faces' counter
    if (bs * is_ * is_ >= 2 ** 31 or bs * nf >= 2 ** 31
            or 3 * ts ** 3 >= 2 ** 31 or pairs >= 2 ** 31 - 1):
        raise ValueError('the texture scatter indexes pixels, faces, a '
                         'cube\'s cells and (tile, face) pairs with int32')
    fim = face_index_map.contiguous()
    out = torch.empty(texture_shape, dtype=torch.float32, device=dev)
    # each face-major row's tile, then the kernel's counter of faces
    row_tile = torch.empty(pairs + 1, dtype=torch.int32, device=dev)
    # z, weights and the rgb gradient channel-leading, depth [bs, 1, is, is]
    maps = (z.permute(0, 3, 1, 2), weight_map.permute(0, 3, 1, 2),
            depth_map[:, None], grad_rgb_map.permute(0, 3, 1, 2))
    _build.launch(
        lib, 'tex_scatter', fim.get_device(), fim.data_ptr(),
        *(bins[k].data_ptr() for k in ('start', 'order', 'first')),
        row_tile.data_ptr(), pairs, bs, nf, is_, ts,
        (_build.PTR * 4)(*(t.data_ptr() for t in maps)),
        (_build.I64 * 16)(*(n for t in maps for n in t.stride())),
        ts - 1 - settings.eps, out.data_ptr(), out.numel())
    tracing.COUNTS['k6.scatter'] += 1
    tracing.COUNTS['work.k6_scatter_cells'] += bs * nf * ts ** 3
    return out
