"""rasterize_core: forward maps composited into (rgb, alpha, depth), and the
approximate backward tied to them.

Mirrors the reference ``Rasterize`` chainer.Function (``rasterize.py:19-897``)
and the JAX package's ``core.py``: the forward runs the shaded kernel
(``forward_cuda``) and composites over the background; the backward is
*defined*, not derived: the paper's approximate vertex gradient (K5), the
exact texture gradient (K6), the analytic depth gradient (K7) and the exact
background gradient.

The backward builds one channel-leading per-pixel stack ``[bs, C, is, is]``:
the 12 K5 channels (in-sweep, then the out-sweep added in place), the 9 K7
channels when depth is drawn, and the ``ts^2 + ts + 3`` K6 factor channels
for ``ts <= 4``.  One per-face reduction (``backward_cuda.face_reduce``,
which on the card sums by the forward's tile lists) sums it, expanding the
factors to texture cells, and the K5 sums are mapped to vertex slots by
``scatter_pixel_channels``.  Only what
``ctx.needs_input_grad`` asks for is computed, and a forward that needs no
gradient saves nothing.

Outputs are raster-space maps: row 0 = top in +y-down pixel space; the
public wrappers in ``api.py`` apply the reference's NCHW transpose / vertical
flip / anti-aliasing (``rasterize.py:953-969``).
"""

import torch

from neural_renderer_torch.rasterize import backward as bwd
from neural_renderer_torch.rasterize import backward_cuda
from neural_renderer_torch.rasterize import forward_cuda, geometry
from neural_renderer_torch.rasterize import texture as tex

# the K6 factors ride the reduction up to this cube size (23 channels at
# ts 4); larger cubes take the 8-corner scatter, as in the JAX package
MAX_FACTOR_TS = 4


def _forward_all(settings, faces, textures, background):
    """Full forward: (rgb, alpha, depth, maps).

    background: f32 ``[3]`` (static color) or ``[bs, 3]`` (per batch
    element, reference rasterize.py:462-465).  Unrequested channels are
    shape-(1,) zeros; rgb is the *composited* map ``[bs, is, is, 3]``.
    maps: the forward kernel's outputs (``forward_cuda.forward_shaded``).
    """
    fuse_rgb = (settings.return_rgb
                and textures.shape[2] <= forward_cuda.MAX_FUSED_TS)
    out = forward_cuda.forward_shaded(settings, faces,
                                      textures if fuse_rgb else None)
    face_index_map = out['face_index_map']
    covered = face_index_map >= 0
    dev = faces.device

    if settings.return_rgb:
        if fuse_rgb:
            rgb_map = out['rgb'].permute(0, 2, 3, 1)
        else:
            rgb_map = tex.sample_textures(
                settings, textures, face_index_map,
                out['z'].permute(0, 2, 3, 1),
                out['weights'].permute(0, 2, 3, 1), out['depth_map'])
        # background composite (rasterize.py:451-465)
        bg = (background[None, None, None, :] if background.ndim == 1
              else background[:, None, None, :])
        mask = covered.to(torch.float32)[..., None]
        rgb_map = rgb_map * mask + (1.0 - mask) * bg
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


def channel_stack(settings, maps, g_rgb, g_alpha, g_depth, k5, k7, k6_ts):
    """The fused per-pixel channel stack ``[bs, C, is, is]``: the 12 K5
    channels (when ``k5``), the 9 K7 channels (when ``k7``) and the
    ``ts^2 + ts + 3`` K6 factors (when ``k6_ts`` > 0), in that order.

    maps: the forward's ``face_index_map``, ``weights``, ``depth_map``,
    ``xy``, ``z`` and the composited ``rgb`` ([bs, is, is, 3], read by K5
    when rgb is drawn); g_*: the output gradients."""
    fim = maps['face_index_map']
    bs, is_ = fim.shape[0], settings.image_size
    naux = k6_ts * k6_ts + k6_ts + 3 if k6_ts else 0
    C = (12 if k5 else 0) + (9 if k7 else 0) + naux
    stack = torch.empty((bs, C, is_, is_), dtype=torch.float32,
                        device=fim.device)
    if k5:
        _k5_stack(settings, stack[:, :12], fim, maps['xy'], maps['rgb'],
                  g_rgb, g_alpha)
    if k7:
        off = 12 if k5 else 0
        stack[:, off:off + 9] = _k7_channels(
            settings, fim >= 0, maps['xy'], maps['z'], maps['weights'],
            maps['depth_map'], g_depth)
    if k6_ts:
        stack[:, C - naux:] = tex.texture_cell_factors(
            settings, fim, maps['z'].permute(0, 2, 3, 1),
            maps['weights'].permute(0, 2, 3, 1), maps['depth_map'],
            g_rgb.permute(0, 3, 1, 2), k6_ts)
    return stack


_SAVED = ('face_index_map', 'weights', 'depth_map', 'xy', 'z', 'rgb')
# the forward kernel's tile lists, which the reduction on the card needs
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
            bins = out.get('bins')
            ctx.tile = bins['tile'] if bins else None
            ctx.save_for_backward(*(out[k] for k in _SAVED),
                                  *(bins[k] if bins else None for k in _BINS))
        return rgb, alpha, depth

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_depth):
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
        k6_ts = ts if (need_tex and s.return_rgb
                       and ts <= MAX_FACTOR_TS) else 0
        sums = None
        if k5 or k7 or k6_ts:
            stack = channel_stack(s, maps, g_rgb, g_alpha, g_depth, k5, k7,
                                  k6_ts)
            sums = backward_cuda.face_reduce(stack, fim, nf, k6_ts, bins)

        grad_faces = grad_textures = grad_bg = None
        if need_faces:
            grad_faces = torch.zeros(face_shape, dtype=torch.float32,
                                     device=dev)
            if k5:
                grad_faces = grad_faces + bwd.scatter_pixel_channels(
                    sums[:, :12], bs, nf)
            if k7:
                off = 12 if k5 else 0
                grad_faces = grad_faces + sums[:, off:off + 9].reshape(
                    face_shape)
        if need_tex:
            if k6_ts:
                grad_textures = sums[:, -ts ** 3 * 3:].reshape(tex_shape)
            elif s.return_rgb:
                grad_textures = tex.grad_textures(
                    s, fim, maps['z'].permute(0, 2, 3, 1),
                    maps['weights'].permute(0, 2, 3, 1), maps['depth_map'],
                    g_rgb, tex_shape)
            else:
                grad_textures = torch.zeros(tex_shape, dtype=torch.float32,
                                            device=dev)
        if need_bg:
            # exact: d(rgb_out)/d(bg) = 1 - coverage (JAX core.py:724-739);
            # the reference treats the background as a constant
            if s.return_rgb:
                uncovered = (fim < 0).to(torch.float32)
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
