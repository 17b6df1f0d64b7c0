"""Per-face texture-cube sampling (K4), forward only.

The reference samples each covered pixel's color by perspective-correcting
its barycentric weights into the face's ``ts^3`` texture cube and blending
the 8 surrounding corners trilinearly (``rasterize.py:361-438``).  This is
the plain PyTorch version; the CUDA forward kernel (``forward_cuda``) fuses
the same arithmetic for ``ts <= 4``.

Deliberate fix vs the reference: K4 reads the winning face's vertex depths
from batch 0 for every batch element (``rasterize.py:389`` indexes
``faces[face_index * 9]`` without the ``bn * nf`` offset — latent bug,
invisible in the reference's tests because they use spatially-uniform
textures).  We read ``faces[bn, face_index]`` correctly.
"""

import torch


def _texture_index_float(settings, face_w, weight_map, depth_map,
                         texture_size):
    """Perspective-corrected texture coords tif [bs,is,is,3]
    (rasterize.py:398-404).  face_w: the winner's gathered vertex rows."""
    ts = texture_size
    z = face_w[..., 2]                  # winner's vertex depths [bs,is,is,3]
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


def sample_textures(settings, textures, face_index_map, face_w, weight_map,
                    depth_map):
    """Forward texture sampling (K4): returns rgb_map [bs, is, is, 3].

    Uncovered pixels are 0 (the background composite happens in core).
    """
    bs, nf, ts = textures.shape[0], textures.shape[1], textures.shape[2]
    is_ = settings.image_size
    covered = face_index_map >= 0
    fidx = face_index_map.clamp(0, nf - 1).long()

    tif = _texture_index_float(settings, face_w, weight_map, depth_map, ts)
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
