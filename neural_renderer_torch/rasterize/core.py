"""rasterize_core: forward maps composited into (rgb, alpha, depth).

Mirrors the reference ``Rasterize`` chainer.Function forward
(``rasterize.py:19-470``) and the JAX package's ``core._forward_all``.  The
forward runs the shaded kernel (``forward_cuda``) and composites over the
background.  The approximate backward (K5 vertex, K6 texture, K7 depth
gradients) is not ported yet: ``RasterizeCore.backward`` raises.

Outputs are raster-space maps: row 0 = top in +y-down pixel space; the
public wrappers in ``api.py`` apply the reference's NCHW transpose / vertical
flip / anti-aliasing (``rasterize.py:953-969``).
"""

import torch

from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize import texture as tex

def _face_w(out):
    """The winner's vertex rows ``[bs, is, is, 3 (vertex), 3 (xyz)]`` from
    the forward's xy [bs, 6, is, is] and z [bs, 3, is, is] maps."""
    xy, z = out['xy'], out['z']
    return torch.stack([xy[:, 0::2], xy[:, 1::2], z], dim=-1).permute(
        0, 2, 3, 1, 4)


def _forward_all(settings, faces, textures, background):
    """Full forward: maps + composited outputs.

    background: f32 ``[3]`` (static color) or ``[bs, 3]`` (per batch
    element, reference rasterize.py:462-465).
    Returns (rgb, alpha, depth); unrequested channels are shape-(1,) zeros.
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
                settings, textures, face_index_map, _face_w(out),
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
    return rgb_map, alpha, depth


class RasterizeCore(torch.autograd.Function):
    """faces [bs,nf,3,3] NDC, textures [bs,nf,ts,ts,ts,3],
    background [3] or [bs,3] -> (rgb [bs,is,is,3], alpha, depth [bs,is,is]).

    The gradient is the reference's *defined* approximate backward, which
    arrives with the K5/K6/K7 port (ROADMAP Queue 1, "Backward math" and
    "Custom op backward"); until then it raises instead of returning a zero
    or partial gradient."""

    @staticmethod
    def forward(ctx, settings, faces, textures, background):
        return _forward_all(settings, faces, textures, background)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            'the rasterizer backward (K5 vertex, K6 texture, K7 depth '
            'gradients) is not ported yet: ROADMAP Queue 1, "Backward math" '
            'and "Custom op backward"')


def rasterize_core(settings, faces, textures, background):
    """Forward through ``RasterizeCore`` (see there)."""
    return RasterizeCore.apply(settings, faces, textures, background)
