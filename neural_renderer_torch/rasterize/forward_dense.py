"""Dense rasterizer forward in plain PyTorch: deterministic per-pixel argmin-z.

The port's correctness oracle, counterpart of the JAX package's
``forward_xla.py``.  It implements the reference's "safe" two-pass semantics
(K2 face_inv precompute, reference ``rasterize.py:238-277``; K3 per-pixel
all-faces z-buffer loop, ``rasterize.py:279-359``) as a streaming reduction:

    for each band of pixel rows:
        cull to the faces that can cover a pixel of the band
        for each chunk of those faces (ascending id):
            for every (pixel, face) pair:  inside tests / weights / depth
            running (min depth, first argmin face)

Tie-breaking matches the reference exactly: the *first* face (lowest index)
with the strictly smallest depth wins, because the reference's sequential
loop only replaces on ``zp < depth_min`` (rasterize.py:334).

The cull is exact and keeps ascending face order.  It drops back faces, faces
whose conservative y-range (the ``+-1`` pixel pad of the bbox absorbs
rounding of the edge tests) misses the band, and faces with a NaN in their
face_inv: a NaN there makes that weight, and so the depth, NaN, which the z
test rejects.  Eager PyTorch does not fuse elementwise work as XLA does;
bands and face chunks bound the ``[bs, rows, is, faces]`` temporaries.
"""

import torch

from neural_renderer_torch.rasterize import geometry

_ROW_BAND = 8
# elements of one [bs, rows, is, faces] temporary: small on the host, large
# on a GPU, where each of the ~40 elementwise ops is one kernel launch
_PAIR_BUDGET_CPU = 1 << 20
_PAIR_BUDGET_GPU = 1 << 24


def _chunk_min(settings, fc, finv, live, xg, yg, xi, yi):
    """Min depth and its first position over one face chunk.

    fc: [bs, C, 3, 3] faces; finv: [bs, C, 3, 3] their face_inv;
    live: [bs, C] bool (False = padding); xg/xi: [is] pixel-center NDC /
    integer x; yg/yi: the band's rows.
    Returns (cmin [bs, R, is], carg [bs, R, is] int64 chunk position).
    """
    z = fc[..., 2]
    # broadcast layout [bs, R(y), is(x), C]
    inside = geometry.inside_tests(xg[None, None, :, None],
                                   yg[None, :, None, None],
                                   fc[:, None, None])

    xi_b = xi[None, None, :, None]
    yi_b = yi[None, :, None, None]

    def wk(k):
        w = (finv[:, None, None, :, k, 0] * xi_b
             + finv[:, None, None, :, k, 1] * yi_b
             + finv[:, None, None, :, k, 2])
        return torch.clamp(w, 0.0, 1.0)

    w0, w1, w2 = wk(0), wk(1), wk(2)
    wsum = w0 + w1 + w2
    # zp = 1 / sum(w_k / z_k) with renormalized weights (rasterize.py:
    # 327-330), evaluated as w_k * (1/z_k) with per-face reciprocals —
    # the same form as the JAX oracle and the CUDA kernel's z test
    iz = 1.0 / z
    zp = wsum / (w0 * iz[:, None, None, :, 0]
                 + w1 * iz[:, None, None, :, 1]
                 + w2 * iz[:, None, None, :, 2])

    valid = (inside
             & (zp > settings.near) & (zp < settings.far)
             & live[:, None, None, :])
    zbuf = torch.where(valid, zp, torch.full_like(zp, float('inf')))
    # torch.min returns the first index of a repeated minimum
    return torch.min(zbuf, dim=-1)


def forward_face_index_map(settings, faces):
    """faces ``[bs, nf, 3, 3]`` NDC -> (face_index_map int32, depth f32).

    face_index_map is -1 for uncovered pixels; depth is ``far`` there
    (reference buffer init, rasterize.py:478-480).
    """
    bs, nf = faces.shape[:2]
    is_ = settings.image_size
    dev = faces.device
    depth = torch.full((bs, is_, is_), settings.far, dtype=torch.float32,
                       device=dev)
    idx = torch.full((bs, is_, is_), -1, dtype=torch.int32, device=dev)
    if nf == 0:
        return idx, depth

    px = geometry.to_pixel_coords(faces[..., 0], is_)
    py = geometry.to_pixel_coords(faces[..., 1], is_)
    finv = geometry.face_inv_matrix(px, py)                    # [bs, nf, 3, 3]
    usable = (geometry.is_frontface(faces)
              & torch.logical_not(torch.isnan(finv).flatten(-2).any(-1)))
    ymin = torch.floor(py.amin(-1)) - 1.0
    ymax = torch.ceil(py.amax(-1)) + 1.0
    xg = geometry.pixel_centers(is_, dev)
    xi = torch.arange(is_, dtype=torch.float32, device=dev)

    for r0 in range(0, is_, _ROW_BAND):
        r1 = min(r0 + _ROW_BAND, is_)
        hit = usable & (ymax >= r0) & (ymin <= r1 - 1)           # [bs, nf]
        counts = hit.sum(1)
        width = int(counts.max())
        if width == 0:
            continue
        # the band's faces first, in ascending id order (stable sort)
        order = torch.sort(torch.logical_not(hit).to(torch.uint8), dim=1,
                           stable=True).indices[:, :width]
        live_all = (torch.arange(width, device=dev)[None, :]
                    < counts[:, None])
        budget = _PAIR_BUDGET_CPU if dev.type == 'cpu' else _PAIR_BUDGET_GPU
        chunk = max(1, budget // (bs * (r1 - r0) * is_))
        yg = xg[r0:r1]
        yi = xi[r0:r1]
        for c0 in range(0, width, chunk):
            ids = order[:, c0:c0 + chunk]                        # [bs, C]
            rows = ids[:, :, None, None].expand(-1, -1, 3, 3)
            cmin, carg = _chunk_min(
                settings, torch.gather(faces, 1, rows),
                torch.gather(finv, 1, rows), live_all[:, c0:c0 + chunk],
                xg, yg, xi, yi)
            win = torch.gather(ids, 1, carg.reshape(bs, -1)).reshape(
                carg.shape).to(torch.int32)
            better = cmin < depth[:, r0:r1]
            depth[:, r0:r1] = torch.where(better, cmin, depth[:, r0:r1])
            idx[:, r0:r1] = torch.where(better, win, idx[:, r0:r1])
    return idx, depth


def gather_face_rows(faces, face_index_map):
    """ONE per-pixel row gather of the winner's 9 vertex coords.

    Returns face_w [bs, is, is, 3, 3] (face 0's rows where uncovered —
    every consumer masks on face_index_map >= 0).
    """
    bs, nf = faces.shape[:2]
    is_ = face_index_map.shape[1]
    fidx = face_index_map.clamp(0, nf - 1).long().reshape(bs, -1, 1)
    return torch.gather(faces.reshape(bs, nf, 9), 1,
                        fidx.expand(-1, -1, 9)).reshape(bs, is_, is_, 3, 3)


def winner_attributes(settings, face_index_map, face_w):
    """Recompute per-pixel weights and depth from the winning face.

    Instead of carrying weight_map through the z-reduction (the reference
    writes it under its pixel lock, rasterize.py:343-348), it is recomputed
    from the winner's gathered vertices (face_w from gather_face_rows) —
    the same math.
    Returns (weight_map [bs,is,is,3], depth [bs,is,is]); zeros / ``far``
    where uncovered.
    """
    is_ = settings.image_size
    dev = face_w.device
    covered = face_index_map >= 0

    px = geometry.to_pixel_coords(face_w[..., 0], is_)
    py = geometry.to_pixel_coords(face_w[..., 1], is_)
    finv = geometry.face_inv_matrix(px, py)                 # [bs,is,is,3,3]
    xi = torch.arange(is_, dtype=torch.float32, device=dev)[None, None, :,
                                                             None]
    yi = torch.arange(is_, dtype=torch.float32, device=dev)[None, :, None,
                                                             None]
    w = finv[..., 0] * xi + finv[..., 1] * yi + finv[..., 2]
    w = geometry.clamp_renormalize_weights(w)
    zp = geometry.perspective_correct_depth(w, face_w[..., 2])

    weight_map = torch.where(covered[..., None], w, torch.zeros_like(w))
    depth_map = torch.where(covered, zp, torch.full_like(zp, settings.far))
    return weight_map, depth_map
