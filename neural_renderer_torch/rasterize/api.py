"""Public rasterization entry points.

Mirrors the reference wrappers (``rasterize.py:900-1065``) and the JAX
package's ``api.py``: 2x supersampling for anti-aliasing, NCHW transpose +
vertical flip, 2x2 average-pool downsample, and the rgb / silhouettes / depth
convenience functions.  Outputs lie on the device of ``faces``.  All are
differentiable (autograd runs the flip and pool around ``RasterizeCore``).
"""

import os
import warnings

import numpy as np
import torch

from neural_renderer_torch.rasterize.config import (
    DEFAULT_ANTI_ALIASING,
    DEFAULT_BACKGROUND_COLOR,
    DEFAULT_EPS,
    DEFAULT_FAR,
    DEFAULT_IMAGE_SIZE,
    DEFAULT_NEAR,
    RasterizeSettings,
    resolve_device,
)
from neural_renderer_torch.rasterize.core import rasterize_core

# API-compat shim for the reference's global unsafe/safe toggle
# (rasterize.py:13-16, 1063-1065) including the NEURAL_RENDERER_UNSAFE
# environment variable, as in the JAX package (api.py:26-42).  The port's
# rasterizer and its scatters are deterministic (no float atomics), so
# "unsafe" has nothing to offer; the flag is accepted and ignored.
USE_UNSAFE_IMPLEMENTATION = bool(
    int(os.environ.get('NEURAL_RENDERER_UNSAFE', '0') or 0))


def use_unsafe_rasterizer(flag):
    """Accepted for compatibility and ignored (warns when ``flag`` is
    true): the port is always deterministic."""
    global USE_UNSAFE_IMPLEMENTATION
    USE_UNSAFE_IMPLEMENTATION = bool(flag)
    if flag:
        warnings.warn(
            'use_unsafe_rasterizer(True) is a no-op: the rasterizer is '
            'always deterministic (no atomics to trade away).')


def _as_tensor(x, dtype=torch.float32, device=None):
    """Tensor of ``dtype``; a tensor keeps its device unless one is given,
    anything else (numpy array, list) lands on ``device`` (default: the
    card, ``config.resolve_device``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def _background_array(background_color, device):
    """Background color as an f32 tensor: [3] static or [bs, 3] per batch
    element (reference rasterize.py:462-465 supports both ndims)."""
    if background_color is None:
        background_color = DEFAULT_BACKGROUND_COLOR
    arr = _as_tensor(background_color, device=device)
    if arr.ndim not in (1, 2) or arr.shape[-1] != 3:
        raise ValueError(
            'background_color must be an RGB triple [3] or per-batch '
            f'colors [bs, 3]; got shape {tuple(arr.shape)}')
    return arr


def _check_inputs(faces, textures, return_rgb):
    """Shape/dtype validation mirroring the reference Rasterize type checks
    (rasterize.py:66-90), with actionable error messages."""
    if faces.ndim != 4 or tuple(faces.shape[2:]) != (3, 3):
        raise ValueError(
            f'faces must be [bs, nf, 3 (vertices), 3 (xyz)]; got '
            f'{tuple(faces.shape)}')
    if not faces.is_floating_point():
        raise ValueError(f'faces must be floating point; got {faces.dtype}')
    if return_rgb:
        ts = textures.shape[2] if textures.ndim == 6 else None
        if (textures.ndim != 6 or textures.shape[5] != 3
                or not (textures.shape[2] == textures.shape[3]
                        == textures.shape[4]) or ts < 2):
            raise ValueError(
                'textures must be [bs, nf, ts, ts, ts, 3] with ts >= 2; '
                f'got {tuple(textures.shape)}')
        if not textures.is_floating_point():
            raise ValueError(
                f'textures must be floating point; got {textures.dtype}')
        if textures.shape[:2] != faces.shape[:2]:
            raise ValueError(
                'faces and textures must agree on [bs, nf]; got faces '
                f'{tuple(faces.shape[:2])} vs textures '
                f'{tuple(textures.shape[:2])}')


class _ValueOfGradTo(torch.autograd.Function):
    """Returns ``a`` exactly and sends the whole output gradient to ``b``:
    the approximate-AA mode grafts the 2x-supersampled VALUE onto the 1x
    render's GRADIENT (JAX api.py:91-111)."""

    @staticmethod
    def forward(ctx, a, b):
        return a

    @staticmethod
    def backward(ctx, g):
        return None, g


def _avg_pool_2x2(x):
    """[bs, (c,) h, w] -> 2x2 mean pool (reference rasterize.py:962-969)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    return x.mean(dim=(-3, -1))


def _render_pass(faces, textures, background, render_size, pool,
                 near, far, eps, return_rgb, return_alpha, return_depth,
                 face_group):
    """One rasterize_core invocation + the reference's output formatting
    (NCHW transpose, vertical flip, optional 2x2 mean pool —
    rasterize.py:953-969).  Returns dict(rgb, alpha, depth) with Nones."""
    settings = RasterizeSettings(
        image_size=render_size, near=float(near), far=float(far),
        eps=float(eps), return_rgb=return_rgb, return_alpha=return_alpha,
        return_depth=return_depth, face_group=face_group).validate()

    rgb, alpha, depth = rasterize_core(settings, faces, textures, background)

    if return_rgb:
        rgb = torch.flip(rgb.permute(0, 3, 1, 2), dims=[2])
        if pool:
            rgb = _avg_pool_2x2(rgb)
    if return_alpha:
        alpha = torch.flip(alpha, dims=[1])
        if pool:
            alpha = _avg_pool_2x2(alpha)
    if return_depth:
        depth = torch.flip(depth, dims=[1])
        if pool:
            depth = _avg_pool_2x2(depth)

    return {
        'rgb': rgb if return_rgb else None,
        'alpha': alpha if return_alpha else None,
        'depth': depth if return_depth else None,
    }


def _prepare(faces, textures, return_rgb):
    """faces/textures as f32 tensors on faces' device, validated; a
    [bs, nf, 1, 1, 1, 3] zero placeholder when rgb is not drawn."""
    faces = _as_tensor(faces)
    if return_rgb:
        if textures is None:
            raise ValueError('textures are required when return_rgb=True')
        textures = _as_tensor(textures, device=faces.device)
        _check_inputs(faces, textures, True)
    else:
        _check_inputs(faces, None, False)
        bs, nf = faces.shape[:2]
        textures = torch.zeros((bs, nf, 1, 1, 1, 3), dtype=torch.float32,
                               device=faces.device)
    return faces, textures


def rasterize_rgbad(
        faces,
        textures=None,
        image_size=DEFAULT_IMAGE_SIZE,
        anti_aliasing=DEFAULT_ANTI_ALIASING,
        near=DEFAULT_NEAR,
        far=DEFAULT_FAR,
        eps=DEFAULT_EPS,
        background_color=DEFAULT_BACKGROUND_COLOR,
        return_rgb=True,
        return_alpha=True,
        return_depth=True,
        face_group=None):
    """Rasterize NDC faces to RGB / alpha / depth images.

    Args mirror the reference ``rasterize_rgbad`` (rasterize.py:900-938):
      faces: ``[bs, nf, 3, 3]`` NDC face vertex coords.
      textures: ``[bs, nf, ts, ts, ts, 3]`` per-face texture cubes
        (required when return_rgb).
      anti_aliasing: render at 2x and average-pool down.  ``'approx'``
        returns the values of ``True`` (the same 2x render, run without
        gradient) with the gradient of a 1x render (``False``), so the
        backward runs at a quarter of the pixels (JAX api.py:197-212).
      face_group: a ``torch.distributed`` process group over which the
        face list is sharded (``RasterizeSettings.face_group``): faces and
        textures are this rank's slice, every rank gets the whole image.

    Returns dict(rgb=[bs,3,H,W], alpha=[bs,H,W], depth=[bs,H,W]) with None
    for unrequested channels.
    """
    faces, textures = _prepare(faces, textures, return_rgb)
    background = _background_array(background_color, faces.device)
    common = (near, far, eps, return_rgb, return_alpha, return_depth,
              face_group)
    if anti_aliasing == 'approx':
        with torch.no_grad():
            val = _render_pass(faces, textures, background, image_size * 2,
                               True, *common)
        if not (torch.is_grad_enabled()
                and (faces.requires_grad or textures.requires_grad
                     or background.requires_grad)):
            return val
        grad = _render_pass(faces, textures, background, image_size, False,
                            *common)
        return {k: None if val[k] is None
                else _ValueOfGradTo.apply(val[k], grad[k]) for k in val}
    render_size = image_size * 2 if anti_aliasing else image_size
    return _render_pass(faces, textures, background, render_size,
                        bool(anti_aliasing), *common)


def rasterize(
        faces, textures,
        image_size=DEFAULT_IMAGE_SIZE, anti_aliasing=DEFAULT_ANTI_ALIASING,
        near=DEFAULT_NEAR, far=DEFAULT_FAR, eps=DEFAULT_EPS,
        background_color=DEFAULT_BACKGROUND_COLOR, face_group=None):
    """RGB images ``[bs, 3, H, W]`` (reference rasterize.py:980-1008)."""
    return rasterize_rgbad(
        faces, textures, image_size, anti_aliasing, near, far, eps,
        background_color, True, False, False, face_group)['rgb']


def rasterize_silhouettes(
        faces,
        image_size=DEFAULT_IMAGE_SIZE, anti_aliasing=DEFAULT_ANTI_ALIASING,
        near=DEFAULT_NEAR, far=DEFAULT_FAR, eps=DEFAULT_EPS, face_group=None):
    """Alpha channels ``[bs, H, W]`` (reference rasterize.py:1011-1034)."""
    return rasterize_rgbad(
        faces, None, image_size, anti_aliasing, near, far, eps, None,
        False, True, False, face_group)['alpha']


def rasterize_depth(
        faces,
        image_size=DEFAULT_IMAGE_SIZE, anti_aliasing=DEFAULT_ANTI_ALIASING,
        near=DEFAULT_NEAR, far=DEFAULT_FAR, eps=DEFAULT_EPS, face_group=None):
    """Depth images ``[bs, H, W]`` (reference rasterize.py:1037-1060)."""
    return rasterize_rgbad(
        faces, None, image_size, anti_aliasing, near, far, eps, None,
        False, False, True, face_group)['depth']


class Rasterize:
    """Compat shim for the reference ``Rasterize`` Function class
    (rasterize.py:19-37): constructed with static config, called on
    ``(faces[, textures])``, returns an ``(rgb, alpha, depth)`` tuple with
    None placeholders.  Note: *no* anti-aliasing wrapper here, exactly like
    the reference class (AA lives in rasterize_rgbad)."""

    def __init__(self, image_size, near, far, eps, background_color,
                 return_rgb=False, return_alpha=False, return_depth=False):
        if not any((return_rgb, return_alpha, return_depth)):
            raise ValueError('nothing to draw')
        # validated now, placed on the device of the faces of each call
        _background_array(background_color, torch.device('cpu'))
        self.background_color = background_color
        self.settings = RasterizeSettings(
            image_size=image_size, near=float(near), far=float(far),
            eps=float(eps), return_rgb=return_rgb,
            return_alpha=return_alpha,
            return_depth=return_depth).validate()

    def __call__(self, faces, textures=None):
        faces, textures = _prepare(faces, textures, self.settings.return_rgb)
        rgb, alpha, depth = rasterize_core(
            self.settings, faces, textures,
            _background_array(self.background_color, faces.device))
        return (rgb if self.settings.return_rgb else None,
                alpha if self.settings.return_alpha else None,
                depth if self.settings.return_depth else None)
