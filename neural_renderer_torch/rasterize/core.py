"""rasterize_core: forward maps composited into (rgb, alpha, depth), and the
approximate backward tied to them.

Mirrors the reference ``Rasterize`` chainer.Function (``rasterize.py:19-897``)
and the JAX package's ``core.py``: the forward runs the shaded kernel
(``forward_cuda``) and composites over the background; the backward is
*defined*, not derived: the paper's approximate vertex gradient (K5), the
exact texture gradient (K6), the analytic depth gradient (K7) and the exact
background gradient.

The backward builds one channel-leading per-pixel stack ``[bs, C, is, is]``:
the 12 K5 channels (in-sweep, then the out-sweep added in place) and the 9
K7 channels when depth is drawn.  One per-face reduction
(``backward_cuda.face_reduce``, which on the card sums by the forward's
tile lists) sums it and, for ``ts <= 4``, the K6 texture cells, whose
factors it builds from the forward's maps and the rgb gradient
(``backward_cuda.K6Maps``; on the card inside its tile pass, for covered
pixels only, so no factor planes are written).  Larger cubes take the
8-corner scatter (``texture.grad_textures``), on the card one kernel that
sums each face's cube from the same tile lists.  One pass
(``backward_cuda.face_grad``, a kernel on the card) maps the K5 sums to
vertex slots and adds the K7 sums into ``grad_faces``.  Only what
``ctx.needs_input_grad`` asks for is computed, and a forward that needs no
gradient saves nothing.

Outputs are raster-space maps: row 0 = top in +y-down pixel space; the
public wrappers in ``api.py`` apply the reference's NCHW transpose / vertical
flip / anti-aliasing (``rasterize.py:953-969``).
"""

import torch
import torch.distributed as dist

from neural_renderer_torch import tracing
from neural_renderer_torch._collectives import all_reduce
from neural_renderer_torch.rasterize import backward as bwd
from neural_renderer_torch.rasterize import backward_cuda, composite_pool
from neural_renderer_torch.rasterize import forward_cuda, geometry
from neural_renderer_torch.rasterize import texture as tex


def _merge_face_group(settings, out, nf_local):
    """Merge the ranks' z-buffers across ``settings.face_group``
    (JAX ``core._merge_face_axis``).

    Each rank rasterized its slice of the face list, rank r holding global
    ids ``r * nf_local ..``.  A pixel's global winner is the (depth, global
    id) minimum over the ranks: one process rasterizing the concatenated
    list keeps the first face of strictly least depth (rasterize.py:334),
    so the merged maps equal its maps bit for bit.  Two MIN reductions find
    the winner and one SUM of the winner-masked maps (``weights``, ``z``,
    ``xy`` and ``rgb``) gives every rank the winner's values; depth is the
    least depth, ``far`` where no rank covers the pixel.

    ``face_index_map`` comes back localized (the rank's local ids where it
    won, -1 elsewhere), so the backward reduces exactly the rank's slice;
    ``global_index_map`` holds the global winner (-1 uncovered), the
    coverage that compositing and the K5 sweeps read.  ``bins`` stay the
    rank's own tile lists."""
    group = settings.face_group
    lo = dist.get_rank(group) * nf_local
    fim = out['face_index_map']
    covered = fim >= 0
    big = torch.iinfo(torch.int32).max
    z = torch.where(covered, out['depth_map'], torch.inf)
    gid = torch.where(covered, fim + lo, big)
    zmin = all_reduce(z.clone(), dist.ReduceOp.MIN, group)
    gid_win = all_reduce(torch.where(z == zmin, gid, big),
                         dist.ReduceOp.MIN, group)
    mine = ((gid == gid_win) & covered)[:, None]
    keys = [k for k in ('weights', 'z', 'xy', 'rgb') if k in out]
    widths = [out[k].shape[1] for k in keys]
    merged = torch.cat([torch.where(mine, out[k], 0.0) for k in keys], 1)
    merged = all_reduce(merged, dist.ReduceOp.SUM, group)
    res = dict(out, **dict(zip(keys, merged.split(widths, 1))))
    res['depth_map'] = torch.where(torch.isinf(zmin), settings.far, zmin)
    res['face_index_map'] = torch.where(
        (gid_win >= lo) & (gid_win < lo + nf_local), gid_win - lo, -1
    ).to(torch.int32)
    res['global_index_map'] = torch.where(gid_win < big, gid_win, -1).to(
        torch.int32)
    return res


def forward_maps(settings, faces, textures):
    """The forward kernel's maps (``forward_cuda.forward_shaded``), rgb
    sampled in when the kernel did not shade it, merged across the face
    group where there is one (``_merge_face_group``).  rgb is the
    uncomposited ``[bs, 3, is, is]``, present when drawn."""
    fuse_rgb = (settings.return_rgb
                and textures.shape[2] <= forward_cuda.MAX_FUSED_TS)
    out = forward_cuda.forward_shaded(settings, faces,
                                      textures if fuse_rgb else None)
    if settings.return_rgb and not fuse_rgb:
        # sampled from the local winners, before a face-group merge
        with tracing.span('raster.shade'):
            out['rgb'] = tex.sample_textures(
                settings, textures, out['face_index_map'],
                out['z'].permute(0, 2, 3, 1),
                out['weights'].permute(0, 2, 3, 1),
                out['depth_map']).permute(0, 3, 1, 2)
    if settings.face_group is not None:
        with tracing.span('raster.merge'):
            out = _merge_face_group(settings, out, faces.shape[1])
    return out


def coverage(maps):
    """The coverage the outputs take: under a face group the global
    winners' (a pixel won by another rank's face is covered too), else the
    face-index map's; int32, covered where >= 0."""
    return maps.get('global_index_map', maps['face_index_map'])


def _forward_all(settings, faces, textures, background):
    """Full forward: (rgb, alpha, depth, maps).

    background: f32 ``[3]`` (static color) or ``[bs, 3]`` (per batch
    element, reference rasterize.py:462-465).  Unrequested channels are
    shape-(1,) zeros; rgb is the *composited* map ``[bs, is, is, 3]``.
    maps: ``forward_maps``.
    """
    out = forward_maps(settings, faces, textures)
    with tracing.span('raster.composite'):
        covered = coverage(out) >= 0
        dev = faces.device

        if settings.return_rgb:
            rgb_map = composite_pool.composite(out['rgb'], covered,
                                               background)
        else:
            rgb_map = torch.zeros(1, dtype=torch.float32, device=dev)

        alpha = (covered.to(torch.float32) if settings.return_alpha
                 else torch.zeros(1, dtype=torch.float32, device=dev))
        depth = (out['depth_map'] if settings.return_depth
                 else torch.zeros(1, dtype=torch.float32, device=dev))
    return rgb_map, alpha, depth, out


def _k5_stack(settings, out, face_index_map, xy, rgb_map, g_rgb, g_alpha):
    """Fill ``out`` ([bs, 12, is, is] view) with the K5 channels: the
    in-sweep, then the out-sweep added in place (JAX backward.py:485-491)."""
    rgb = grad_rgb = grad_alpha = None
    if settings.return_rgb:
        rgb = rgb_map.permute(0, 3, 1, 2)
        grad_rgb = g_rgb.permute(0, 3, 1, 2)
    if settings.return_alpha:
        grad_alpha = g_alpha
    backward_cuda.insweep(settings, xy, face_index_map, rgb, grad_rgb,
                          grad_alpha, out=out)
    backward_cuda.outsweep(settings, xy, face_index_map, rgb, grad_rgb,
                           grad_alpha, out=out, accumulate=True)


def _k7_channels(settings, covered, xy, z, weights, depth_map, g_depth):
    """K7 channels [bs, 9, is, is]; face_inv is recomputed from the
    winner's xy (JAX core.py:424-432)."""
    ppx, ppy = bwd.pixel_coords(xy, settings.image_size)
    finv = geometry.face_inv_matrix(ppx, ppy)
    finv = torch.where(covered[..., None, None], finv, 0.0)
    return bwd.depth_channels(settings, covered, z.permute(0, 2, 3, 1), finv,
                              weights.permute(0, 2, 3, 1), depth_map, g_depth)


def channel_stack(settings, maps, g_rgb, g_alpha, g_depth, k5, k7):
    """The fused per-pixel channel stack ``[bs, C, is, is]``: the 12 K5
    channels (when ``k5``) and the 9 K7 channels (when ``k7``), in that
    order; ``C`` is 0 with neither.  The K6 factors are not in it: the
    reduction builds them (``backward_cuda.K6Maps``).

    maps: the forward's ``face_index_map``, ``weights``, ``depth_map``,
    ``xy``, ``z`` and the composited ``rgb`` ([bs, is, is, 3], read by K5
    when rgb is drawn), and under a face group ``global_index_map``: the
    K5 sweeps take their coverage from it, so their channels are the same
    on every rank, and the reduction drops the pixels other ranks won;
    g_*: the output gradients."""
    fim = maps['face_index_map']
    cover = maps.get('global_index_map')
    cover = fim if cover is None else cover
    bs, is_ = fim.shape[0], settings.image_size
    C = (12 if k5 else 0) + (9 if k7 else 0)
    stack = torch.empty((bs, C, is_, is_), dtype=torch.float32,
                        device=fim.device)
    if k5:
        with tracing.span('backward.k5'):
            _k5_stack(settings, stack[:, :12], cover, maps['xy'],
                      maps['rgb'], g_rgb, g_alpha)
    if k7:
        off = 12 if k5 else 0
        with tracing.span('backward.k7'):
            stack[:, off:off + 9] = _k7_channels(
                settings, fim >= 0, maps['xy'], maps['z'], maps['weights'],
                maps['depth_map'], g_depth)
    return stack


_SAVED = ('face_index_map', 'weights', 'depth_map', 'xy', 'z', 'rgb',
          'global_index_map')
# the forward kernel's tile lists, which the reduction and the texture
# scatter on the card need
_BINS = ('start', 'ids', 'order', 'first')


class RasterizeCore(torch.autograd.Function):
    """faces [bs,nf,3,3] NDC, textures [bs,nf,ts,ts,ts,3],
    background [3] or [bs,3] -> (rgb [bs,is,is,3], alpha, depth [bs,is,is]).

    The gradient is the reference's *defined* approximate backward (see the
    module docstring) with respect to faces, textures and background."""

    @staticmethod
    def forward(ctx, settings, faces, textures, background):
        rgb, alpha, depth, out = _forward_all(settings, faces, textures,
                                              background)
        ctx.settings = settings
        ctx.shapes = (tuple(faces.shape), tuple(textures.shape),
                      tuple(background.shape))
        if any(ctx.needs_input_grad):
            # alpha is the coverage of face_index_map
            out['rgb'] = rgb if settings.return_rgb else None
            out.setdefault('global_index_map', None)
            bins = out.get('bins')
            ctx.tile = bins['tile'] if bins else None
            ctx.save_for_backward(*(out[k] for k in _SAVED),
                                  *(bins[k] if bins else None for k in _BINS))
        return rgb, alpha, depth

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth):
        with tracing.span('backward'):
            return RasterizeCore._backward(ctx, g_rgb, g_alpha, g_depth)

    @staticmethod
    def _backward(ctx, g_rgb, g_alpha, g_depth):
        s = ctx.settings
        saved = ctx.saved_tensors
        maps = dict(zip(_SAVED, saved))
        bins = (dict(zip(_BINS, saved[len(_SAVED):]), tile=ctx.tile)
                if ctx.tile else None)
        fim = maps['face_index_map']
        face_shape, tex_shape, bg_shape = ctx.shapes
        _, need_faces, need_tex, need_bg = ctx.needs_input_grad
        bs, nf = face_shape[:2]
        ts = tex_shape[2]
        dev = fim.device

        k5 = need_faces and (s.return_rgb or s.return_alpha)
        k7 = need_faces and s.return_depth
        k6 = (backward_cuda.K6Maps(s, ts, maps['z'], maps['weights'],
                                   maps['depth_map'], g_rgb)
              if need_tex and s.return_rgb
              and ts <= backward_cuda.MAX_FACTOR_TS else None)
        sums = None
        if k5 or k7 or k6 is not None:
            stack = channel_stack(s, maps, g_rgb, g_alpha, g_depth, k5, k7)
            with tracing.span('backward.reduce'):
                sums = backward_cuda.face_reduce(stack, fim, nf, k6, bins)

        grad_faces = grad_textures = grad_bg = None
        if need_faces:
            if sums is None:
                # nothing drawn: no K5 or K7 term, the gradient is zeros
                sums = torch.empty((bs * nf, 0), dtype=torch.float32,
                                   device=dev)
            with tracing.span('backward.scatter'):
                grad_faces = backward_cuda.face_grad(
                    sums, face_shape, k5, (12 if k5 else 0) if k7 else None)
        if need_tex:
            if k6 is not None:
                grad_textures = sums[:, -ts ** 3 * 3:].reshape(tex_shape)
            elif s.return_rgb:
                with tracing.span('backward.k6'):
                    grad_textures = tex.grad_textures(
                        s, fim, maps['z'].permute(0, 2, 3, 1),
                        maps['weights'].permute(0, 2, 3, 1),
                        maps['depth_map'], g_rgb, tex_shape, bins)
            else:
                grad_textures = torch.zeros(tex_shape, dtype=torch.float32,
                                            device=dev)
        if need_bg:
            # exact: d(rgb_out)/d(bg) = 1 - coverage (JAX core.py:724-739);
            # the reference treats the background as a constant
            if s.return_rgb:
                cover = maps['global_index_map']
                uncovered = ((fim if cover is None else cover) < 0).to(
                    torch.float32)
                grad_bg = (g_rgb * uncovered[..., None]).sum(dim=(1, 2))
                if len(bg_shape) == 1:
                    grad_bg = grad_bg.sum(0)
            else:
                grad_bg = torch.zeros(bg_shape, dtype=torch.float32,
                                      device=dev)
        return None, grad_faces, grad_textures, grad_bg


def rasterize_core(settings, faces, textures, background):
    """Forward through ``RasterizeCore`` (see there)."""
    return RasterizeCore.apply(settings, faces, textures, background)
