"""The rasterizer's output pass: the background composite, the vertical flip
and the 2x2 mean pool that turn the forward's maps into the images of
``rasterize_rgbad`` (reference rasterize.py:451-465, 953-969).

The math has one copy, in plain PyTorch:

  * ``composite``: rgb over the background where no face covers a pixel;
  * ``flip_pool``: the NCHW transpose, the vertical flip and the optional
    2x2 mean pool of each output;
  * ``composite_pool_plain``: the two in a row, from the maps.

``RasterizeCore`` composites with ``composite`` and ``api`` formats its
outputs with ``flip_pool``: that route saves the composited map for the
backward.  Where no gradient can flow, ``api`` takes ``composite_pool``
instead: on a CUDA tensor the hand-written kernel of
``csrc/composite_pool.cu``, which reads the maps once and writes the
final outputs (counted as ``tracing.COUNTS['launch.composite_pool']``), on a
CPU tensor ``composite_pool_plain``.  The kernel's sums follow the order of
torch's CUDA mean (see the source), so both give the same bits.
"""

import torch

from neural_renderer_torch import _build
from neural_renderer_torch.rasterize.config import on_card


def composite(rgb, covered, background):
    """The composited rgb map ``[bs, is, is, 3]``: ``rgb [bs, 3, is, is]``
    (uncomposited) where ``covered [bs, is, is]``, the background ``[3]``
    or ``[bs, 3]`` elsewhere (rasterize.py:451-465)."""
    rgb_map = rgb.permute(0, 2, 3, 1)
    bg = (background[None, None, None, :] if background.ndim == 1
          else background[:, None, None, :])
    mask = covered.to(torch.float32)[..., None]
    return rgb_map * mask + (1.0 - mask) * bg


def _avg_pool_2x2(x):
    """[bs, (c,) h, w] -> 2x2 mean pool (reference rasterize.py:962-969)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    return x.mean(dim=(-3, -1))


def flip_pool(settings, rgb, alpha, depth, pool):
    """The outputs of raster-space ``rgb [bs, is, is, 3]``, ``alpha`` and
    ``depth [bs, is, is]``: NCHW, flipped vertically and, where ``pool``,
    2x2 mean pooled (rasterize.py:953-969).  dict(rgb, alpha, depth), None
    where ``settings`` does not ask for the output."""
    def post(x, dim):
        x = torch.flip(x, dims=[dim])
        return _avg_pool_2x2(x) if pool else x

    return dict(
        rgb=post(rgb.permute(0, 3, 1, 2), 2) if settings.return_rgb else None,
        alpha=post(alpha, 1) if settings.return_alpha else None,
        depth=post(depth, 1) if settings.return_depth else None)


def composite_pool_plain(settings, cover, rgb, depth, background, pool):
    """The plain PyTorch version of ``composite_pool``: ``composite``, then
    ``flip_pool``."""
    covered = cover >= 0
    return flip_pool(
        settings,
        composite(rgb, covered, background) if settings.return_rgb else None,
        covered.to(torch.float32) if settings.return_alpha else None,
        depth, pool)


def composite_pool(settings, cover, rgb, depth, background, pool):
    """The outputs of ``rasterize_rgbad`` from the forward's maps, where no
    gradient flows: dict(rgb ``[bs, 3, H, W]``, alpha, depth ``[bs, H,
    W]``), None where ``settings`` does not ask for the output; ``H = is /
    2`` where ``pool``, else ``is``.

    cover: int32 ``[bs, is, is]``, covered where >= 0 (the global winner
    under a face group); rgb: the uncomposited ``[bs, 3, is, is]`` as the
    forward kernel writes it (channel planes, any batch stride) or as
    ``texture.sample_textures`` permuted (channel-last); depth: ``[bs, is,
    is]``; background: ``[3]`` or ``[bs, 3]``.  Only what an output needs
    is read.  A CUDA tensor launches the kernel (or raises) into new
    contiguous outputs; a CPU tensor runs ``composite_pool_plain``."""
    if not on_card(cover):
        return composite_pool_plain(settings, cover, rgb, depth, background,
                                    pool)
    bs, is_ = cover.shape[0], settings.image_size
    plane = is_ * is_
    _require(cover.dtype == torch.int32 and cover.shape == (bs, is_, is_)
             and cover.is_contiguous(),
             f'cover must be int32 [bs, {is_}, {is_}] contiguous; got '
             f'{cover.dtype} {tuple(cover.shape)}')
    inputs = [cover]
    interleaved, rgb_bstride = 0, 0
    if settings.return_rgb:
        _require(rgb is not None and rgb.dtype == torch.float32
                 and rgb.shape == (bs, 3, is_, is_),
                 f'rgb must be float32 [{bs}, 3, {is_}, {is_}]; got '
                 f'{None if rgb is None else (rgb.dtype, tuple(rgb.shape))}')
        if rgb.stride()[1:] == (plane, is_, 1):
            rgb_bstride = rgb.stride(0)
        elif rgb.stride() == (3 * plane, 1, 3 * is_, 3):
            interleaved, rgb_bstride = 1, 3 * plane
        else:
            raise ValueError('rgb must be channel planes [bs, 3, is, is] '
                             'or a permuted [bs, is, is, 3] contiguous map; '
                             f'got strides {rgb.stride()}')
        bg = background.contiguous()
        _require(bg.dtype == torch.float32 and bg.shape in ((3,), (bs, 3)),
                 f'background must be float32 [3] or [{bs}, 3]; got '
                 f'{bg.dtype} {tuple(bg.shape)}')
        inputs += [rgb, bg]
    if settings.return_depth:
        _require(depth.dtype == torch.float32
                 and depth.shape == (bs, is_, is_) and depth.is_contiguous(),
                 f'depth must be float32 [{bs}, {is_}, {is_}] contiguous; '
                 f'got {depth.dtype} {tuple(depth.shape)}')
        inputs.append(depth)
    _require(all(t.device == cover.device for t in inputs),
             'the maps and the background must be on one device')
    if pool and is_ % 2:
        raise ValueError(f'a 2x2 pool needs an even raster; got {is_}')

    size = is_ // 2 if pool else is_

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=cover.device)

    out = dict(rgb=empty(bs, 3, size, size) if settings.return_rgb else None,
               alpha=empty(bs, size, size) if settings.return_alpha else None,
               depth=empty(bs, size, size) if settings.return_depth else None)
    ptr = _build.ptr
    _build.launch(
        _build.library('composite_pool'), 'composite_pool',
        cover.get_device(), cover.data_ptr(),
        ptr(rgb if settings.return_rgb else None),
        ptr(depth if settings.return_depth else None),
        ptr(bg if settings.return_rgb else None), bs, is_, int(pool),
        rgb_bstride, interleaved,
        3 if settings.return_rgb and bg.ndim == 2 else 0,
        ptr(out['rgb']), ptr(out['alpha']), ptr(out['depth']))
    return out


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)
