"""Backward pass, plain PyTorch: the approximate vertex gradient (K5)
re-derived pixel-centrically, and the analytic depth gradient (K7).

Counterpart of the JAX package's ``rasterize/backward.py`` (dense, exact
paths only).  The reference K5 (``rasterize.py:517-748``) walks, for each
face, edge and walk axis, the columns (rows) the edge crosses and at every
crossing sweeps pixels "out" toward the image border and "in" toward the
opposite edge, accumulating ``-diff_grad / dist`` wherever moving the edge
over a pixel would lower the loss (``diff_grad > 0``).  Pixel-centrically:

  * **in-sweep**: a pixel takes part in its own face's in-sweep, so every
    covered pixel rebuilds the crossing of its face's edge with its own
    column (row) and tests itself against the sweep interval;
  * **out-sweep**: a crossing is active iff its in-pixel is covered by the
    face (``d1_in == d1``); each active crossing sums over its column (row)
    from ``d1_out`` to the border, written at the in-pixel.

Both produce channel-leading ``[bs, 12, is, is]`` stacks, (c0, c1) per
(edge, axis) in ``_EA`` order, reduced per face by the caller.  Every
expression keeps the JAX package's (and the reference's) operand order; the
CUDA kernels (``backward_cuda``) repeat it.  Gradients are with respect to
NDC face coordinates (pixel distances map back with ``2/is``,
rasterize.py:649).

The per-pixel inputs are the forward's winner maps in the layout the CUDA
forward writes them: ``ppx``/``ppy`` ``[bs, is, is, 3]`` pixel-space vertex
coordinates (``pixel_coords``), ``covered`` ``[bs, is, is]`` bool, and value
and gradient maps ``rgb``/``grad_rgb`` ``[bs, 3, is, is]``,
``alpha``/``grad_alpha`` ``[bs, is, is]`` (None when not drawn).
"""

import torch

from neural_renderer_torch.rasterize import forward_dense, geometry

# (edge, axis) walk order, axis-major: channel 2 * _EA.index((e, a)) + k
# holds term c_k of edge e walked along axis a (JAX backward.py:46)
_EA = [(e, a) for a in range(2) for e in range(3)]

# grad_faces' K5 slots: (slot 3 * v + c, column of c0, column of c1) of the
# 12 per-face K5 sums.  Slot (vertex v, coord c < 2) receives the c0 column
# of walk (e=v, a=1-c) plus the c1 column of walk (e=(v+2)%3, a=1-c); the z
# slots receive none (JAX backward.py:540-565).  backward_cuda.face_grad
# adds them.
K5_SLOTS = tuple((3 * v + c, 2 * _EA.index((v, 1 - c)),
                  2 * _EA.index(((v + 2) % 3, 1 - c)) + 1)
                 for v in range(3) for c in range(2))

# elements of one [bs, rows, is, is] temporary of the plain out-sweep
_SWEEP_ELEMS = 1 << 24


def pixel_coords(xy, image_size):
    """The forward's NDC ``xy`` planes ``[bs, 6, is, is]`` -> pixel-space
    (ppx, ppy), each ``[bs, is, is, 3]`` (geometry.to_pixel_coords)."""
    px = geometry.to_pixel_coords(xy[:, 0::2], image_size)
    py = geometry.to_pixel_coords(xy[:, 1::2], image_size)
    return px.permute(0, 2, 3, 1), py.permute(0, 2, 3, 1)


def _edge_coords(ppx, ppy, e, a):
    """Walk-frame coordinates of edge e (and the opposite vertex): X along
    the walk axis, Y along the sweep axis, for vertex order
    ``pi = [(e+0)%3, (e+1)%3, (e+2)%3]`` (rasterize.py:547-556)."""
    pi = [(e + k) % 3 for k in range(3)]
    if a == 0:
        return [ppx[..., i] for i in pi], [ppy[..., i] for i in pi]
    return [ppy[..., i] for i in pi], [ppx[..., i] for i in pi]


def _direction(X0, X1, a):
    """Sweep direction +-1 (rasterize.py:559-564)."""
    if a == 0:
        return torch.where(X0 < X1, -1.0, 1.0)
    return torch.where(X0 < X1, 1.0, -1.0)


def _crossing(settings, X, Y, a, d0):
    """The crossing of edge (X0, Y0)-(X1, Y1) with walk line d0: direction,
    d1_cross, d1_in, d1_out (floats holding integers) and ``valid``
    (crossing exists and both pixels lie on screen, rasterize.py:567-579).
    """
    is_ = settings.image_size
    X0, X1, _ = X
    Y0, Y1, _ = Y
    direction = _direction(X0, X1, a)
    # d0 loop bounds (rasterize.py:568-569); C's float->int truncation of
    # the upper bound is trunc
    d0_from = torch.clamp(torch.ceil(torch.minimum(X0, X1)), min=0.0)
    d0_to = torch.trunc(torch.clamp(torch.maximum(X0, X1), max=is_ - 1.0))
    in_extent = (d0 >= d0_from) & (d0 <= d0_to)

    d1_cross = (Y1 - Y0) / (X1 - X0) * (d0 - X0) + Y0
    d1_in = torch.where(direction > 0, torch.floor(d1_cross),
                        torch.ceil(d1_cross))
    d1_out = d1_in + direction
    valid = (in_extent
             & (d1_in >= 0) & (d1_in <= is_ - 1)
             & (d1_out >= 0) & (d1_out <= is_ - 1))
    return dict(direction=direction, d1_cross=d1_cross, d1_in=d1_in,
                d1_out=d1_out, valid=valid)


def _in_limit(X, Y, d0, direction):
    """Opposite-edge limit of the in-sweep (rasterize.py:663-670); C's
    float->int of NaN gives 0."""
    X0, X1, X2 = X
    Y0, Y1, Y2 = Y
    mid = (d0 - X0) * (d0 - X2) < 0
    c_a = (Y2 - Y0) / (X2 - X0) * (d0 - X0) + Y0
    c_b = (Y1 - Y2) / (X1 - X2) * (d0 - X2) + Y2
    d0_cross2 = torch.where(mid, c_a, c_b)
    lim = torch.where(direction > 0, torch.ceil(d0_cross2),
                      torch.floor(d0_cross2))
    return torch.where(torch.isnan(lim), 0.0, lim)


def _dist_contrib(settings, diff_grad, delta, X0, X1, d0):
    """The two ``-diff_grad / dist`` terms (rasterize.py:648-657, 719-728),
    to vertex pi[0] (c0) and pi[1] (c1), gated on ``diff_grad > 0``."""
    is_ = settings.image_size
    eps = settings.eps
    gate = diff_grad > 0

    def one(k_num, k_den):
        dist = k_num / k_den * delta * 2.0 / is_
        dist = torch.where(dist > 0, dist + eps, dist - eps)
        return -diff_grad / dist

    c0 = torch.where(gate & (X1 != d0), one(X1 - X0, X1 - d0), 0.0)
    c1 = torch.where(gate & (X0 != d0), one(X1 - X0, d0 - X0), 0.0)
    return c0, c1


def _map_gather(m, row, col):
    """m ``[bs, is, is]``; row/col ``[bs, is, is]`` int64 -> m[b, row, col]."""
    bs, is_ = m.shape[0], m.shape[1]
    idx = (row * is_ + col).reshape(bs, -1)
    return torch.gather(m.reshape(bs, -1), 1, idx).reshape(row.shape)


def _pixel_grid(bs, is_, device):
    """Float pixel indices yi, xi broadcast to ``[bs, is, is]``."""
    i = torch.arange(is_, dtype=torch.float32, device=device)
    return (i[None, :, None].expand(bs, is_, is_),
            i[None, None, :].expand(bs, is_, is_))


def _value_diff(settings, alpha, grad_alpha, rgb, grad_rgb, a_ref, rgb_ref):
    """``diff_grad``: the alpha term first, then
    ``sum_c (rgb_c - rgb_ref_c) * grad_rgb_c`` summed over c = 0, 1, 2 in
    order (rasterize.py:688-695); maps broadcast against the refs."""
    dg = torch.zeros_like(a_ref if a_ref is not None else rgb_ref[:, 0])
    if settings.return_alpha:
        dg = dg + (alpha - a_ref) * grad_alpha
    if settings.return_rgb:
        t = [(rgb[:, c] - rgb_ref[:, c]) * grad_rgb[:, c] for c in range(3)]
        dg = dg + (t[0] + t[1] + t[2])
    return dg


def insweep_channels(settings, ppx, ppy, covered, rgb, grad_rgb, alpha,
                     grad_alpha):
    """K5 in-sweep: ``[bs, 12, is, is]`` (JAX backward.py:455-483, the exact
    gather).  Each covered pixel q, for each edge of its face and each walk
    axis, fetches the crossing's out-pixel value and, when q lies in
    ``[d1_in, opposite edge]``, writes the two gated ``-dg/dist`` terms."""
    bs, is_ = covered.shape[:2]
    yi, xi = _pixel_grid(bs, is_, covered.device)
    chans = []
    for e, a in _EA:
        X, Y = _edge_coords(ppx, ppy, e, a)
        d0 = xi if a == 0 else yi
        d1 = yi if a == 0 else xi
        cr = _crossing(settings, X, Y, a, d0)
        lim = _in_limit(X, Y, d0, cr['direction'])
        lo2 = torch.clamp(torch.minimum(cr['d1_in'], lim), min=0.0)
        hi2 = torch.clamp(torch.maximum(cr['d1_in'], lim), max=is_ - 1.0)
        act_in = covered & cr['valid'] & (d1 >= lo2) & (d1 <= hi2)

        # the out-pixel (rasterize.py:688-695): column d0 / row d1_out for
        # a = 0, row d0 / column d1_out for a = 1 (any pixel where the
        # crossing is not valid: act_in masks its terms)
        out_d1 = torch.where(cr['valid'], cr['d1_out'], 0.0).long()
        d0_i = d0.long()
        row, col = (out_d1, d0_i) if a == 0 else (d0_i, out_d1)
        a_out = (_map_gather(alpha, row, col) if settings.return_alpha
                 else None)
        rgb_out = (torch.stack([_map_gather(rgb[:, c], row, col)
                                for c in range(3)], dim=1)
                   if settings.return_rgb else None)
        dg = _value_diff(settings, alpha, grad_alpha, rgb, grad_rgb, a_out,
                         rgb_out)
        delta = d1 - cr['d1_cross']
        c0, c1 = _dist_contrib(settings, dg, delta, X[0], X[1], d0)
        chans += [torch.where(act_in, c0, 0.0), torch.where(act_in, c1, 0.0)]
    return torch.stack(chans, dim=1)


def _out_sweep(settings, a, act_out, cr, X, d0, alpha, grad_alpha, rgb,
               grad_rgb):
    """Out-sweep totals (c0, c1) ``[bs, is, is]`` at each in-pixel r: the
    masked reduction along r's column (a = 0) or row (a = 1) over
    ``[d1_out, border]`` (JAX backward.py:791-879).  Rows are processed in
    chunks of R so the ``[bs, R, is, is]`` temporaries stay within
    ``_SWEEP_ELEMS`` elements."""
    is_ = settings.image_size
    bs = act_out.shape[0]
    d1_limit = torch.where(cr['direction'] > 0, float(is_ - 1), 0.0)
    lo = torch.clamp(torch.minimum(cr['d1_out'], d1_limit), min=0.0)
    hi = torch.clamp(torch.maximum(cr['d1_out'], d1_limit), max=is_ - 1.0)

    def line(m):
        """[bs, (c,) is, is] -> the sweep lines [bs, (c,) line, pos]."""
        return m.transpose(-1, -2) if a == 0 else m

    l_a = None if alpha is None else line(alpha)
    l_ga = None if grad_alpha is None else line(grad_alpha)
    l_rgb = None if rgb is None else line(rgb)
    l_grgb = None if grad_rgb is None else line(grad_rgb)
    d1s = torch.arange(is_, dtype=torch.float32, device=act_out.device)

    rows = max(1, min(is_, _SWEEP_ELEMS // (bs * is_ * is_)))
    c0_parts, c1_parts = [], []
    for r0 in range(0, is_, rows):
        sl = slice(r0, min(r0 + rows, is_))

        def lines(m):
            """Each pixel's sweep line, [bs, (c,) R, is, is]."""
            if m is None:
                return None
            if a == 0:       # line id = column = the pixel's x
                return m.unsqueeze(-3)
            return m[..., sl, :].unsqueeze(-2)     # line id = row = y

        def own(m):
            return None if m is None else m[..., sl, :].unsqueeze(-1)

        dg = _value_diff(settings, lines(l_a), lines(l_ga), lines(l_rgb),
                         lines(l_grgb), own(alpha), own(rgb))
        in_range = ((d1s >= own(lo)) & (d1s <= own(hi)) & own(act_out))
        dg = torch.where(in_range, dg, 0.0)
        delta = d1s - own(cr['d1_cross'])
        c0, c1 = _dist_contrib(settings, dg, delta, own(X[0]), own(X[1]),
                               own(d0))
        c0_parts.append(c0.sum(-1))
        c1_parts.append(c1.sum(-1))
    return torch.cat(c0_parts, dim=1), torch.cat(c1_parts, dim=1)


def outsweep_channels(settings, ppx, ppy, covered, rgb, grad_rgb, alpha,
                      grad_alpha):
    """K5 out-sweep: ``[bs, 12, is, is]``, each active crossing's sum over
    its line written at its in-pixel (JAX backward.py:485-491)."""
    bs, is_ = covered.shape[:2]
    yi, xi = _pixel_grid(bs, is_, covered.device)
    chans = []
    for e, a in _EA:
        X, Y = _edge_coords(ppx, ppy, e, a)
        d0 = xi if a == 0 else yi
        d1 = yi if a == 0 else xi
        cr = _crossing(settings, X, Y, a, d0)
        act_out = covered & cr['valid'] & (cr['d1_in'] == d1)
        chans += list(_out_sweep(settings, a, act_out, cr, X, d0, alpha,
                                 grad_alpha, rgb, grad_rgb))
    return torch.stack(chans, dim=1)


def face_segments(face_index_map, nf):
    """Per-pixel segment ids ``[bs, is, is]``: pixel -> its face's slot in
    ``[bs * nf]``; uncovered pixels go to the overflow slot ``bs * nf``."""
    bs = face_index_map.shape[0]
    b = torch.arange(bs, dtype=torch.int64,
                     device=face_index_map.device)[:, None, None]
    return torch.where(face_index_map >= 0, b * nf + face_index_map,
                       bs * nf)


def depth_channels(settings, covered, z, face_inv_map, weight_map,
                   depth_map, grad_depth_map):
    """K7 per-pixel contributions ``[bs, 9, is, is]`` (rasterize.py:794-847);
    channel ``v*3 + c`` is (vertex v, coord c):

        dL/dz_k += g * w_k * d^2 / z_k^2,
        dL/d(x,y)_k += -g * tmp_l * w_k * d^2 * is/2,
        tmp_l = sum_rows(-face_inv[row, l] / z_row).

    z ``[bs, is, is, 3]`` (the winner's vertex depths), face_inv_map
    ``[bs, is, is, 3, 3]``, weight_map ``[bs, is, is, 3]``."""
    is_ = settings.image_size
    d2 = depth_map * depth_map
    g = grad_depth_map
    q = -face_inv_map / z[..., None]
    tmp = q[..., 0, :] + q[..., 1, :] + q[..., 2, :]
    ng = -g
    chans = []
    for v in range(3):
        for c in range(2):
            chans.append(ng * tmp[..., c] * weight_map[..., v] * d2
                         * (is_ / 2.0))
        chans.append(g * weight_map[..., v] * d2 / (z[..., v] * z[..., v]))
    contrib = torch.stack(chans, dim=1)
    return torch.where(covered[:, None], contrib, 0.0)


def out_sweep_stats(settings, faces, face_index_map):
    """One walk of the covered pixels' crossings of their own face's edges
    with their own column (row), as the out-sweep finds them, for every
    (edge, axis) of ``_EA``.  Returns a dict of Python numbers:

      * ``out_crossings``: most active crossings of one (batch element,
        axis), the JAX package's ``grad_out_cap`` requirement;
      * ``row_crossings``: most of one (batch element, axis, image row), its
        ``grad_row_cap`` requirement (JAX backward.py:601-631);
      * ``out_offset``: largest ``|d1_out - pixel|`` over the valid
        crossings, its ``grad_offset_radius`` requirement (JAX
        backward.py:205-230);
      * ``active`` and ``positions``: all active crossings, and the
        positions they sweep (each from ``d1_out`` to the border): the
        port's out-sweep work, which has no capacity and no radius;
      * ``sweep_lines`` and ``line_pixels``: the (batch element, axis,
        line) that hold an active crossing, and the pixels that lie on at
        least one of them: what the out-sweep must read of the value and
        gradient planes."""
    bs = faces.shape[0]
    is_ = settings.image_size
    covered = face_index_map >= 0
    face_w = forward_dense.gather_face_rows(faces, face_index_map)
    ppx = geometry.to_pixel_coords(face_w[..., 0], is_)
    ppy = geometry.to_pixel_coords(face_w[..., 1], is_)
    yi, xi = _pixel_grid(bs, is_, faces.device)
    rows = [0, 0]                      # per axis [bs, is], summed over edges
    lines = [False, False]             # per axis [bs, is]: the line sweeps
    offset, active, positions = 0.0, 0, 0
    for e, a in _EA:
        X, Y = _edge_coords(ppx, ppy, e, a)
        d0 = xi if a == 0 else yi
        d1 = yi if a == 0 else xi
        cr = _crossing(settings, X, Y, a, d0)
        valid = covered & cr['valid']
        act = valid & (cr['d1_in'] == d1)
        rows[a] = rows[a] + act.sum(dim=2)
        # axis 0 sweeps the column x (= d0), axis 1 the row y
        lines[a] = lines[a] | act.any(dim=1 if a == 0 else 2)
        off = torch.where(valid, torch.abs(cr['d1_out'] - d1), 0.0)
        offset = max(offset, float(off.max()))
        span = torch.where(cr['direction'] > 0, is_ - cr['d1_out'],
                           cr['d1_out'] + 1.0)
        active += int(act.sum())
        positions += int(span[act].sum())
    cols, rws = lines[0].sum(1), lines[1].sum(1)
    return dict(
        out_crossings=max(int(r.sum(1).max()) for r in rows),
        row_crossings=max(int(r.max()) for r in rows),
        out_offset=offset, active=active, positions=positions,
        sweep_lines=int((cols + rws).sum()),
        line_pixels=int(((cols + rws) * is_ - cols * rws).sum()))


def count_out_crossings(settings, faces, face_index_map, per_row=False):
    """Most active out-sweep crossings of one (batch element, axis), or
    with ``per_row=True`` of one (batch element, axis, image row)
    (``out_sweep_stats``)."""
    stats = out_sweep_stats(settings, faces, face_index_map)
    return stats['row_crossings' if per_row else 'out_crossings']


def max_out_offset(settings, faces, face_index_map):
    """Largest ``|d1_out - pixel|`` over the valid crossings of covered
    pixels (``out_sweep_stats``)."""
    return out_sweep_stats(settings, faces, face_index_map)['out_offset']
