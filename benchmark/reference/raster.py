"""The rasterizer of the Neural 3D Mesh Renderer in plain PyTorch: a dense
z-buffer, texture sampling, the background composite, and the reference's
defined approximate backward (K5 sweeps, K6 texture gradient, K7 depth
gradient), with no kernel, no tile list and no cache.

Semantics are the reference's ``rasterize.py``:

* pixel-space vertex ``p = 0.5 (x is + is - 1)``; pixel centre
  ``(2 i + 1 - is) / is`` in NDC (``:258``, ``:291``);
* a face is skipped when ``(y2-y0)(x1-x0) < (y1-y0)(x2-x0)`` (``:252``);
  weights are clamped to [0, 1], then renormalised (``:322-327``); depth
  ``1 / sum_k w_k / z_k`` (``:330``); a pixel keeps the first face (lowest
  id) of strictly least depth inside (near, far) (``:334``);
* K4 samples the ``ts^3`` cube trilinearly at perspective-corrected
  weights, clamped to ``ts - 1 - eps`` (``:361-438``), reading the winner's
  depths from its own batch element;
* K5 (``:517-748``) walks each covered pixel's face edges along both axes:
  the in-sweep tests the pixel against its face's crossing and opposite
  edge, the out-sweep sums ``-diff_grad / dist`` from the crossing's
  out-pixel to the border; K6 (``:750-792``) scatters the 8 corner
  weights times the rgb gradient; K7 (``:794-847``) is the analytic depth
  gradient.

Every tensor made here takes the dtype of ``faces``.  The work is cut into
bands of rows and chunks of faces so that temporaries stay small.
"""

import dataclasses

import torch

# (edge, axis) walk order: channel 2 * EA.index((e, a)) + k holds term c_k
# of edge e walked along axis a
EA = [(e, a) for a in range(2) for e in range(3)]

_ROW_BAND = 8


def _budget(device, cpu, gpu):
    return cpu if device.type == 'cpu' else gpu


@dataclasses.dataclass(frozen=True)
class Settings:
    image_size: int
    near: float = 0.1
    far: float = 100.0
    eps: float = 1e-4
    return_rgb: bool = True
    return_alpha: bool = True
    return_depth: bool = True


# --------------------------------------------------------------- geometry

def to_pixel(v, is_):
    return 0.5 * (v * is_ + is_ - 1.0)


def pixel_centers(is_, like):
    i = torch.arange(is_, device=like.device, dtype=like.dtype)
    return (2.0 * i + 1.0 - is_) / is_


def is_front(faces):
    x0, y0 = faces[..., 0, 0], faces[..., 0, 1]
    x1, y1 = faces[..., 1, 0], faces[..., 1, 1]
    x2, y2 = faces[..., 2, 0], faces[..., 2, 1]
    return torch.logical_not((y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0))


def face_inv(px, py):
    """``[..., 3, 3]`` with ``w_k = out[k] . (xi, yi, 1)`` (``:261-269``)."""
    p0x, p1x, p2x = px[..., 0], px[..., 1], px[..., 2]
    p0y, p1y, p2y = py[..., 0], py[..., 1], py[..., 2]
    denom = p2x * (p0y - p1y) + p0x * (p1y - p2y) + p1x * (p2y - p0y)
    rows = torch.stack([
        torch.stack([p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y], dim=-1),
        torch.stack([p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y], dim=-1),
        torch.stack([p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y], dim=-1),
    ], dim=-2)
    return rows / denom[..., None, None]


def _inside(xp, yp, faces):
    x0, y0 = faces[..., 0, 0], faces[..., 0, 1]
    x1, y1 = faces[..., 1, 0], faces[..., 1, 1]
    x2, y2 = faces[..., 2, 0], faces[..., 2, 1]
    t0 = (yp - y0) * (x1 - x0) < (xp - x0) * (y1 - y0)
    t1 = (yp - y1) * (x2 - x1) < (xp - x1) * (y2 - y1)
    t2 = (yp - y2) * (x0 - x2) < (xp - x2) * (y0 - y2)
    return torch.logical_not(t0 | t1 | t2)


# ---------------------------------------------------------- the z-buffer

def _chunk_min(s, fc, finv, live, xg, yg, xi, yi):
    """(least depth, its first chunk position) per pixel of a band."""
    z = fc[..., 2]
    inside = _inside(xg[None, None, :, None], yg[None, :, None, None],
                     fc[:, None, None])
    xi_b, yi_b = xi[None, None, :, None], yi[None, :, None, None]

    def wk(k):
        w = (finv[:, None, None, :, k, 0] * xi_b
             + finv[:, None, None, :, k, 1] * yi_b
             + finv[:, None, None, :, k, 2])
        return torch.clamp(w, 0.0, 1.0)

    w0, w1, w2 = wk(0), wk(1), wk(2)
    iz = 1.0 / z
    zp = (w0 + w1 + w2) / (w0 * iz[:, None, None, :, 0]
                           + w1 * iz[:, None, None, :, 1]
                           + w2 * iz[:, None, None, :, 2])
    valid = inside & (zp > s.near) & (zp < s.far) & live[:, None, None, :]
    zbuf = torch.where(valid, zp, torch.full_like(zp, float('inf')))
    return torch.min(zbuf, dim=-1)


def face_index_map(s, faces):
    """NDC faces ``[bs, nf, 3, 3]`` -> face index ``[bs, is, is]`` (int32,
    -1 uncovered), by rows of pixels against the faces that reach them."""
    bs, nf = faces.shape[:2]
    is_ = s.image_size
    dev, dt = faces.device, faces.dtype
    depth = torch.full((bs, is_, is_), s.far, dtype=dt, device=dev)
    idx = torch.full((bs, is_, is_), -1, dtype=torch.int32, device=dev)
    if nf == 0:
        return idx
    px, py = to_pixel(faces[..., 0], is_), to_pixel(faces[..., 1], is_)
    finv = face_inv(px, py)
    usable = is_front(faces) & ~torch.isnan(finv).flatten(-2).any(-1)
    ymin = torch.floor(py.amin(-1)) - 1.0
    ymax = torch.ceil(py.amax(-1)) + 1.0
    xg = pixel_centers(is_, faces)
    xi = torch.arange(is_, dtype=dt, device=dev)
    budget = _budget(dev, 1 << 20, 1 << 25)
    for r0 in range(0, is_, _ROW_BAND):
        r1 = min(r0 + _ROW_BAND, is_)
        hit = usable & (ymax >= r0) & (ymin <= r1 - 1)
        counts = hit.sum(1)
        width = int(counts.max())
        if width == 0:
            continue
        order = torch.sort((~hit).to(torch.uint8), dim=1,
                           stable=True).indices[:, :width]
        live = torch.arange(width, device=dev)[None, :] < counts[:, None]
        chunk = max(1, budget // (bs * (r1 - r0) * is_))
        for c0 in range(0, width, chunk):
            ids = order[:, c0:c0 + chunk]
            rows = ids[:, :, None, None].expand(-1, -1, 3, 3)
            cmin, carg = _chunk_min(
                s, torch.gather(faces, 1, rows), torch.gather(finv, 1, rows),
                live[:, c0:c0 + chunk], xg, xg[r0:r1], xi, xi[r0:r1])
            win = torch.gather(ids, 1, carg.reshape(bs, -1)).reshape(
                carg.shape).to(torch.int32)
            better = cmin < depth[:, r0:r1]
            depth[:, r0:r1] = torch.where(better, cmin, depth[:, r0:r1])
            idx[:, r0:r1] = torch.where(better, win, idx[:, r0:r1])
    return idx


def winner_rows(faces, fim):
    """Each pixel's winning face's vertices ``[bs, is, is, 3, 3]`` (face
    0's where uncovered; every user masks those)."""
    bs, nf = faces.shape[:2]
    is_ = fim.shape[1]
    f = fim.clamp(0, nf - 1).long().reshape(bs, -1, 1)
    return torch.gather(faces.reshape(bs, nf, 9), 1,
                        f.expand(-1, -1, 9)).reshape(bs, is_, is_, 3, 3)


def winner_weights(s, fim, face_w):
    """(weights ``[bs, is, is, 3]``, depth ``[bs, is, is]``) at the winner,
    zeros and ``far`` where uncovered."""
    is_ = s.image_size
    covered = fim >= 0
    px, py = to_pixel(face_w[..., 0], is_), to_pixel(face_w[..., 1], is_)
    finv = face_inv(px, py)
    xi = torch.arange(is_, dtype=face_w.dtype, device=face_w.device)
    w = (finv[..., 0] * xi[None, None, :, None]
         + finv[..., 1] * xi[None, :, None, None] + finv[..., 2])
    w = torch.clamp(w, 0.0, 1.0)
    w = w / (w[..., 0:1] + w[..., 1:2] + w[..., 2:3])
    q = w / face_w[..., 2]
    zp = 1.0 / (q[..., 0] + q[..., 1] + q[..., 2])
    return (torch.where(covered[..., None], w, torch.zeros_like(w)),
            torch.where(covered, zp, torch.full_like(zp, s.far)))


# ------------------------------------------------------- K4 and K6

def _tif(s, z, w, depth, ts):
    t = w * (ts - 1) * (depth[..., None] / z)
    return torch.clamp(torch.clamp(t, min=0.0), max=ts - 1 - s.eps)


def _corner(tif, lo, pn, ts):
    frac = tif - lo.to(tif.dtype)
    w, ii = 1.0, []
    for k in range(3):
        if (pn >> k) % 2 == 0:
            w = w * (1.0 - frac[..., k])
            ii.append(lo[..., k])
        else:
            w = w * frac[..., k]
            ii.append(lo[..., k] + 1)
    return w, ii[0] * ts * ts + ii[1] * ts + ii[2]


def sample(s, textures, fim, z, w, depth):
    """K4: rgb ``[bs, is, is, 3]``, 0 where uncovered."""
    bs, nf, ts = textures.shape[:3]
    is_ = s.image_size
    f = fim.clamp(0, nf - 1).long()
    tif = _tif(s, z, w, depth, ts)
    lo = tif.to(torch.int64).clamp(0, ts - 2)
    cells = ts ** 3
    flat = textures.reshape(bs, nf * cells, 3)
    rgb = torch.zeros((bs, is_, is_, 3), dtype=textures.dtype,
                      device=textures.device)
    for pn in range(8):
        wc, isc = _corner(tif, lo, pn, ts)
        g = (f * cells + isc).reshape(bs, -1, 1).expand(-1, -1, 3)
        rgb = rgb + wc[..., None] * torch.gather(flat, 1, g).reshape(
            bs, is_, is_, 3)
    return torch.where((fim >= 0)[..., None], rgb, torch.zeros_like(rgb))


def texture_grad(s, fim, z, w, depth, g_rgb, tex_shape):
    """K6: ``grad[b, f, cell] += w_corner * g_rgb[pixel]`` over the 8
    corners of every covered pixel; g_rgb ``[bs, is, is, 3]``."""
    bs, nf, ts = tex_shape[:3]
    covered = fim >= 0
    f = fim.clamp(0, nf - 1).long()
    cells = ts ** 3
    tif = _tif(s, z, w, depth, ts)
    lo = tif.to(torch.int64).clamp(0, ts - 2)
    boff = (torch.arange(bs, device=f.device) * (nf * cells))[:, None, None]
    out = torch.zeros((bs * nf * cells, 3), dtype=g_rgb.dtype,
                      device=g_rgb.device)
    for pn in range(8):
        wc, isc = _corner(tif, lo, pn, ts)
        seg = (f * cells + isc + boff)[covered]
        out.index_add_(0, seg, (wc[..., None] * g_rgb)[covered])
    return out.reshape(tex_shape)


# ------------------------------------------------------------------ K5

def _walk(ppx, ppy, e, a):
    pi = [(e + k) % 3 for k in range(3)]
    if a == 0:
        return [ppx[..., i] for i in pi], [ppy[..., i] for i in pi]
    return [ppy[..., i] for i in pi], [ppx[..., i] for i in pi]


def _crossing(s, X, Y, a, d0):
    """Direction, d1_cross, d1_in, d1_out and validity of edge (X0, Y0) -
    (X1, Y1) against walk line d0 (``:559-579``)."""
    is_ = s.image_size
    X0, X1, _ = X
    Y0, Y1, _ = Y
    if a == 0:
        direction = torch.where(X0 < X1, -1.0, 1.0).to(X0.dtype)
    else:
        direction = torch.where(X0 < X1, 1.0, -1.0).to(X0.dtype)
    d0_from = torch.clamp(torch.ceil(torch.minimum(X0, X1)), min=0.0)
    d0_to = torch.trunc(torch.clamp(torch.maximum(X0, X1), max=is_ - 1.0))
    d1_cross = (Y1 - Y0) / (X1 - X0) * (d0 - X0) + Y0
    d1_in = torch.where(direction > 0, torch.floor(d1_cross),
                        torch.ceil(d1_cross))
    d1_out = d1_in + direction
    valid = ((d0 >= d0_from) & (d0 <= d0_to)
             & (d1_in >= 0) & (d1_in <= is_ - 1)
             & (d1_out >= 0) & (d1_out <= is_ - 1))
    return dict(direction=direction, d1_cross=d1_cross, d1_in=d1_in,
                d1_out=d1_out, valid=valid)


def _in_limit(X, Y, d0, direction):
    X0, X1, X2 = X
    Y0, Y1, Y2 = Y
    mid = (d0 - X0) * (d0 - X2) < 0
    c = torch.where(mid, (Y2 - Y0) / (X2 - X0) * (d0 - X0) + Y0,
                    (Y1 - Y2) / (X1 - X2) * (d0 - X2) + Y2)
    lim = torch.where(direction > 0, torch.ceil(c), torch.floor(c))
    return torch.where(torch.isnan(lim), torch.zeros_like(lim), lim)


def _terms(s, dg, delta, X0, X1, d0):
    """The two gated ``-diff_grad / dist`` terms (``:648-657``)."""
    is_, eps = s.image_size, s.eps
    gate = dg > 0

    def one(num, den):
        dist = num / den * delta * 2.0 / is_
        dist = torch.where(dist > 0, dist + eps, dist - eps)
        return -dg / dist

    zero = torch.zeros((), dtype=dg.dtype, device=dg.device)
    return (torch.where(gate & (X1 != d0), one(X1 - X0, X1 - d0), zero),
            torch.where(gate & (X0 != d0), one(X1 - X0, d0 - X0), zero))


def _diff(s, alpha, g_alpha, rgb, g_rgb, a_ref, rgb_ref):
    """diff_grad: the alpha term, then the rgb terms summed in order."""
    dg = torch.zeros_like(a_ref if a_ref is not None else rgb_ref[:, 0])
    if s.return_alpha:
        dg = dg + (alpha - a_ref) * g_alpha
    if s.return_rgb:
        t = [(rgb[:, c] - rgb_ref[:, c]) * g_rgb[:, c] for c in range(3)]
        dg = dg + (t[0] + t[1] + t[2])
    return dg


def _grid(bs, is_, like):
    i = torch.arange(is_, dtype=like.dtype, device=like.device)
    return (i[None, :, None].expand(bs, is_, is_),
            i[None, None, :].expand(bs, is_, is_))


def _at(m, row, col):
    bs, is_ = m.shape[0], m.shape[1]
    idx = (row * is_ + col).reshape(bs, -1)
    return torch.gather(m.reshape(bs, -1), 1, idx).reshape(row.shape)


def insweep(s, ppx, ppy, covered, rgb, g_rgb, alpha, g_alpha):
    """K5's in-sweep terms ``[bs, 12, is, is]`` at every covered pixel."""
    bs, is_ = covered.shape[:2]
    yi, xi = _grid(bs, is_, ppx)
    chans = []
    for e, a in EA:
        X, Y = _walk(ppx, ppy, e, a)
        d0, d1 = (xi, yi) if a == 0 else (yi, xi)
        cr = _crossing(s, X, Y, a, d0)
        lim = _in_limit(X, Y, d0, cr['direction'])
        lo = torch.clamp(torch.minimum(cr['d1_in'], lim), min=0.0)
        hi = torch.clamp(torch.maximum(cr['d1_in'], lim), max=is_ - 1.0)
        act = covered & cr['valid'] & (d1 >= lo) & (d1 <= hi)
        out = torch.where(cr['valid'], cr['d1_out'],
                          torch.zeros_like(cr['d1_out'])).long()
        d0i = d0.long()
        row, col = (out, d0i) if a == 0 else (d0i, out)
        a_out = _at(alpha, row, col) if s.return_alpha else None
        rgb_out = (torch.stack([_at(rgb[:, c], row, col) for c in range(3)],
                               dim=1) if s.return_rgb else None)
        dg = _diff(s, alpha, g_alpha, rgb, g_rgb, a_out, rgb_out)
        c0, c1 = _terms(s, dg, d1 - cr['d1_cross'], X[0], X[1], d0)
        zero = torch.zeros_like(c0)
        chans += [torch.where(act, c0, zero), torch.where(act, c1, zero)]
    return torch.stack(chans, dim=1)


def _out_lines(s, a, act, cr, X, d0, alpha, g_alpha, rgb, g_rgb):
    """The out-sweep's two totals ``[bs, is, is]`` at each in-pixel: the
    terms summed along its column (a = 0) or row (a = 1) from the
    crossing's out-pixel to the border, in blocks of rows."""
    is_ = s.image_size
    bs = act.shape[0]
    border = torch.where(cr['direction'] > 0, float(is_ - 1), 0.0).to(
        act.device, cr['d1_out'].dtype)
    lo = torch.clamp(torch.minimum(cr['d1_out'], border), min=0.0)
    hi = torch.clamp(torch.maximum(cr['d1_out'], border), max=is_ - 1.0)

    def line(m):
        return None if m is None else (m.transpose(-1, -2) if a == 0 else m)

    l_a, l_ga, l_rgb, l_grgb = (line(alpha), line(g_alpha), line(rgb),
                                line(g_rgb))
    d1s = torch.arange(is_, dtype=lo.dtype, device=act.device)
    rows = max(1, min(is_, _budget(act.device, 1 << 24, 1 << 26)
                      // (bs * is_ * is_)))
    c0s, c1s = [], []
    for r0 in range(0, is_, rows):
        sl = slice(r0, min(r0 + rows, is_))

        def lines(m):
            if m is None:
                return None
            return m.unsqueeze(-3) if a == 0 else m[..., sl, :].unsqueeze(-2)

        def own(m):
            return None if m is None else m[..., sl, :].unsqueeze(-1)

        dg = _diff(s, lines(l_a), lines(l_ga), lines(l_rgb), lines(l_grgb),
                   own(alpha), own(rgb))
        keep = (d1s >= own(lo)) & (d1s <= own(hi)) & own(act)
        dg = torch.where(keep, dg, torch.zeros_like(dg))
        c0, c1 = _terms(s, dg, d1s - own(cr['d1_cross']), own(X[0]),
                        own(X[1]), own(d0))
        c0s.append(c0.sum(-1))
        c1s.append(c1.sum(-1))
    return torch.cat(c0s, dim=1), torch.cat(c1s, dim=1)


def outsweep(s, ppx, ppy, covered, rgb, g_rgb, alpha, g_alpha):
    """K5's out-sweep totals ``[bs, 12, is, is]`` at each active
    crossing's in-pixel."""
    bs, is_ = covered.shape[:2]
    yi, xi = _grid(bs, is_, ppx)
    chans = []
    for e, a in EA:
        X, Y = _walk(ppx, ppy, e, a)
        d0, d1 = (xi, yi) if a == 0 else (yi, xi)
        cr = _crossing(s, X, Y, a, d0)
        act = covered & cr['valid'] & (cr['d1_in'] == d1)
        chans += list(_out_lines(s, a, act, cr, X, d0, alpha, g_alpha, rgb,
                                 g_rgb))
    return torch.stack(chans, dim=1)


def k5_to_faces(sums, bs, nf):
    """Per-face K5 sums ``[bs * nf, 12]`` -> ``[bs, nf, 3, 3]``: vertex v,
    coordinate c takes the c0 term of walk (v, 1 - c) and the c1 term of
    walk ((v + 2) % 3, 1 - c); z takes nothing."""
    cols = []
    for v in range(3):
        for c in range(2):
            cols.append(sums[:, 2 * EA.index((v, 1 - c))]
                        + sums[:, 2 * EA.index(((v + 2) % 3, 1 - c)) + 1])
        cols.append(torch.zeros_like(cols[-1]))
    return torch.stack(cols, dim=-1).reshape(bs, nf, 3, 3)


def depth_terms(s, covered, z, finv, w, depth, g_depth):
    """K7 per pixel ``[bs, 9, is, is]``, channel ``v * 3 + c``."""
    is_ = s.image_size
    d2 = depth * depth
    q = -finv / z[..., None]
    tmp = q[..., 0, :] + q[..., 1, :] + q[..., 2, :]
    chans = []
    for v in range(3):
        for c in range(2):
            chans.append(-g_depth * tmp[..., c] * w[..., v] * d2
                         * (is_ / 2.0))
        chans.append(g_depth * w[..., v] * d2 / (z[..., v] * z[..., v]))
    out = torch.stack(chans, dim=1)
    return torch.where(covered[:, None], out, torch.zeros_like(out))


def per_face(channels, fim, nf):
    """Sum per-pixel channels ``[bs, C, is, is]`` by the pixel's face:
    ``[bs * nf, C]`` (uncovered pixels add nothing)."""
    bs, C = channels.shape[:2]
    covered = fim >= 0
    b = torch.arange(bs, device=fim.device)[:, None, None].expand_as(fim)
    seg = (b * nf + fim.long())[covered]
    rows = channels.permute(0, 2, 3, 1)[covered]
    out = torch.zeros((bs * nf, C), dtype=channels.dtype,
                      device=channels.device)
    return out.index_add_(0, seg, rows)


# ------------------------------------------------------------ the Function

def forward_maps(s, faces, textures):
    """The forward's maps: face index, winner rows, weights, depth, and
    the sampled rgb (0 where uncovered; None without rgb)."""
    fim = face_index_map(s, faces)
    face_w = winner_rows(faces, fim)
    w, depth = winner_weights(s, fim, face_w)
    rgb = (sample(s, textures, fim, face_w[..., 2], w, depth)
           if s.return_rgb else None)
    return dict(fim=fim, face_w=face_w, w=w, depth=depth, rgb=rgb)


class Rasterize(torch.autograd.Function):
    """(faces, textures, background) -> raster rgb ``[bs, is, is, 3]``
    composited over the background, alpha and depth ``[bs, is, is]``; the
    backward is the reference's approximate one."""

    @staticmethod
    def forward(ctx, s, faces, textures, background):
        m = forward_maps(s, faces, textures)
        covered = m['fim'] >= 0
        mask = covered.to(faces.dtype)[..., None]
        rgb = (m['rgb'] * mask + (1.0 - mask) * background
               if s.return_rgb else None)
        alpha = covered.to(faces.dtype)
        ctx.s, ctx.nf = s, faces.shape[1]
        ctx.tex_shape = tuple(textures.shape)
        ctx.save_for_backward(m['fim'], m['face_w'], m['w'], m['depth'],
                              rgb if s.return_rgb else faces.new_zeros(1),
                              alpha)
        return (rgb if s.return_rgb else faces.new_zeros(1), alpha,
                m['depth'])

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth):
        s = ctx.s
        fim, face_w, w, depth, rgb, alpha = ctx.saved_tensors
        bs, is_ = fim.shape[:2]
        nf = ctx.nf
        covered = fim >= 0
        _, need_faces, need_tex, _ = ctx.needs_input_grad
        grad_faces = grad_tex = None
        if need_faces:
            ppx = to_pixel(face_w[..., 0], is_)
            ppy = to_pixel(face_w[..., 1], is_)
            grad_faces = torch.zeros((bs, nf, 3, 3), dtype=face_w.dtype,
                                     device=fim.device)
            if s.return_rgb or s.return_alpha:
                args = (rgb.permute(0, 3, 1, 2) if s.return_rgb else None,
                        g_rgb.permute(0, 3, 1, 2) if s.return_rgb else None,
                        alpha if s.return_alpha else None,
                        g_alpha if s.return_alpha else None)
                k5 = (insweep(s, ppx, ppy, covered, *args)
                      + outsweep(s, ppx, ppy, covered, *args))
                grad_faces = grad_faces + k5_to_faces(
                    per_face(k5, fim, nf), bs, nf)
            if s.return_depth:
                finv = torch.where(covered[..., None, None],
                                   face_inv(ppx, ppy),
                                   torch.zeros_like(face_w))
                k7 = depth_terms(s, covered, face_w[..., 2], finv, w, depth,
                                 g_depth)
                grad_faces = grad_faces + per_face(k7, fim, nf).reshape(
                    bs, nf, 3, 3)
        if need_tex:
            if s.return_rgb:
                grad_tex = texture_grad(s, fim, face_w[..., 2], w, depth,
                                        g_rgb, ctx.tex_shape)
            else:
                grad_tex = torch.zeros(ctx.tex_shape, dtype=face_w.dtype,
                                       device=fim.device)
        return None, grad_faces, grad_tex, None


def _pool(x):
    h, w = x.shape[-2], x.shape[-1]
    return x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def rasterize(faces, textures, image_size, anti_aliasing, near, far, eps,
              background, outputs):
    """The reference's ``rasterize_rgbad``: a 2x raster and 2x2 mean pool
    under anti-aliasing, NCHW rgb, the vertical flip.  ``outputs``: the
    names drawn among 'rgb', 'alpha', 'depth'.  Returns a dict of them."""
    size = image_size * 2 if anti_aliasing else image_size
    s = Settings(size, near, far, eps, 'rgb' in outputs, 'alpha' in outputs,
                 'depth' in outputs)
    if textures is None:
        textures = faces.new_zeros((faces.shape[0], faces.shape[1], 1, 1, 1,
                                    3))
    bg = torch.as_tensor(background, dtype=faces.dtype, device=faces.device)
    rgb, alpha, depth = Rasterize.apply(s, faces, textures, bg)
    res = {}
    for name, img in (('rgb', rgb), ('alpha', alpha), ('depth', depth)):
        if name not in outputs:
            continue
        if name == 'rgb':
            img = img.permute(0, 3, 1, 2)
        img = torch.flip(img, dims=[-2])
        res[name] = _pool(img) if anti_aliasing else img
    return res
