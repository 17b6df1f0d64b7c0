"""The backward's CUDA kernels and their plain versions.

Four hand-written kernels carry the rasterizer's approximate backward on
the card:

  * ``insweep`` (``csrc/backward_sweeps.cu``, replaces the TPU kernel
    ``backward_pallas._kernel``): the K5 in-sweep, ``[bs, 12, is, is]``;
  * ``outsweep`` (same source, replaces ``backward_pallas.
    _outsweep_kernel``): the K5 out-sweep, ``[bs, 12, is, is]``, written or
    added to the in-sweep's channels;
  * ``face_reduce`` (``csrc/face_reduce.cu``, replaces ``backward_pallas.
    _csr_kernel`` and its segment_sum): per-face sums of the fused
    per-pixel channel stack (K5, K7) and of the K6 texture cells, whose
    factors its tile pass builds from the forward's maps, per (tile, face)
    pair of the forward's tile lists and then per face;
  * ``face_grad`` (same source, replaces the JAX package's XLA scatter of
    the K5 sums, ``neural_renderer_tpu/rasterize/backward.py:540-565``):
    ``grad_faces`` from the per-face sums, the K5 sums added in their
    vertex slots and the K7 columns after them, in one pass.

Each wrapper sends a CPU tensor to its plain PyTorch version
(``insweep_plain``, ``outsweep_plain``, ``face_reduce_plain``,
``face_grad_plain``) and a CUDA
tensor to its kernel, which it launches or raises; any other device raises.
``tracing.COUNTS`` counts each kernel's launches (``launch.<kernel>``),
never plain-version calls.

The sweeps read the forward's maps as the CUDA forward writes them: ``xy``
``[bs, 6, is, is]`` (the winner's NDC x0 y0 x1 y1 x2 y2), ``face_index_map``
``[bs, is, is]`` int32, and value/gradient planes ``rgb``, ``grad_rgb``
``[bs, 3, is, is]`` (the *composited* rgb; any strides, so the permuted
NHWC maps go in as they are) and ``grad_alpha`` ``[bs, is, is]``.  Alpha
is the coverage of ``face_index_map``.  Which terms enter follows
``settings.return_rgb`` / ``return_alpha``.
"""

import functools
import typing

import torch

from neural_renderer_torch import _build, tracing
from neural_renderer_torch.rasterize import backward as bwd
from neural_renderer_torch.rasterize import config
from neural_renderer_torch.rasterize import texture as tex
from neural_renderer_torch.rasterize.config import on_card


# the out-sweep's crossing-list entries per detection group (3 edges of 2
# positions for each of 256 threads): the least list a staged line gets
_OUT_GROUP = 3 * 2 * 256
# a crossing-list entry (d1_cross, two factors, key, first item), bytes
_OUT_ENTRY = 20
# the zeros staged before and after a line
_OUT_PAD = 32
# shared memory of an out-sweep block that reads its planes from device
# memory: no opt-in needed, so several blocks share an SM
_OUT_UNSTAGED_SMEM = 48 * 1024


def outsweep_plan(is_, rgb, alpha, smem_limit, cap=None, staged=None):
    """The out-sweep kernel's layout for lines of ``is_`` pixels:
    dict(staged, cap, smem).

    ``staged``: the line's (value, gradient) planes live in shared memory,
    32 bytes a position with rgb and alpha drawn (``csrc/
    backward_sweeps.cu``); otherwise the kernel reads them from device
    memory.  ``cap``: the crossing list's entries; a line with more active
    crossings (at most ``3 * is_``) is swept in rounds of ``cap``.
    ``smem``: the block's dynamic shared memory in bytes, within
    ``smem_limit`` (what the device's opt-in limit per block leaves beside
    the kernel's static shared memory).

    The planes are staged when they leave room for a list of one detection
    group (``_OUT_GROUP`` entries), and the list takes the rest, up to the
    ``3 * is_`` a line can hold; unstaged lines keep a list that fits
    48 KB.  ``cap`` given (at least 3) overrides the list size and
    ``staged`` the choice of where the planes live: a test forces rounds
    and device-memory planes with them."""
    words = 3 * bool(rgb) + bool(alpha)
    planes = 8 * words * (is_ + 2 * _OUT_PAD)
    full = 3 * is_

    def smem(staged, k):
        return (planes if staged else 0) + 4 + _OUT_ENTRY * k

    if staged is None:
        staged = smem(True, min(full, _OUT_GROUP if cap is None else cap)
                      ) <= smem_limit
    if cap is None:
        room = smem_limit if staged else min(smem_limit, _OUT_UNSTAGED_SMEM)
        cap = min(full, (room - smem(staged, 0)) // _OUT_ENTRY)
    if cap < 3:
        raise ValueError(f'the crossing list needs 3 entries; got {cap}')
    if smem(staged, cap) > smem_limit:
        raise ValueError(f'a {cap}-entry crossing list needs '
                         f'{smem(staged, cap)} bytes of shared memory; the '
                         f'device offers {smem_limit}')
    return dict(staged=staged, cap=cap, smem=smem(staged, cap))


@functools.cache
def _smem_limit(device_index):
    """The dynamic shared memory an out-sweep block may take on CUDA device
    ``device_index``: its opt-in limit per block less the kernel's static
    shared memory."""
    lib = _build.library('backward_sweeps')
    with _build.current_device(device_index):
        limit = lib.nr_outsweep_smem_limit()
    if limit <= 0:
        _build.raise_on_error(lib, -limit, 'smem query')
    return limit


def _strides(t):
    """A map's 4 element strides as a C array (None for no map)."""
    return None if t is None else (_build.I64 * 4)(*t.stride())


def _check_sweep_inputs(settings, xy, face_index_map, rgb, grad_rgb,
                        grad_alpha):
    bs, is_ = face_index_map.shape[0], settings.image_size
    want = {'xy': (xy, (bs, 6, is_, is_), torch.float32),
            'face_index_map': (face_index_map, (bs, is_, is_), torch.int32)}
    if settings.return_rgb:
        want['rgb'] = (rgb, (bs, 3, is_, is_), torch.float32)
        want['grad_rgb'] = (grad_rgb, (bs, 3, is_, is_), torch.float32)
    if settings.return_alpha:
        want['grad_alpha'] = (grad_alpha, (bs, is_, is_), torch.float32)
    if not (settings.return_rgb or settings.return_alpha):
        raise ValueError('the K5 sweeps need rgb or alpha')
    for name, (t, shape, dtype) in want.items():
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype
                or t.device != xy.device):
            raise ValueError(
                f'{name} must be {dtype} {shape} on {xy.device}; got '
                + ('None' if t is None else
                   f'{t.dtype} {tuple(t.shape)} on {t.device}'))


def _check_out(out, bs, is_):
    """A [bs, 12, is, is] float32 view whose batch rows may lie apart
    (a channel slice of a larger stack) but whose planes are dense."""
    if (out.dtype != torch.float32 or tuple(out.shape) != (bs, 12, is_, is_)
            or out.stride()[1:] != (is_ * is_, is_, 1)):
        raise ValueError('out must be a float32 [bs, 12, is, is] view with '
                         f'dense planes; got {out.dtype} {tuple(out.shape)} '
                         f'strides {out.stride()}')


def _launch_sweep(name, settings, xy, face_index_map, rgb, grad_rgb,
                  grad_alpha, out, *extra):
    """Launch ``nr_<name>`` into ``out``.  rgb and grad rgb go in their own
    layout (any strides: the permuted NHWC maps need no copy); the other
    maps as dense tensors; None for the terms not drawn."""
    bs, is_ = face_index_map.shape[0], settings.image_size
    if not settings.return_rgb:
        rgb = grad_rgb = None
    xy, fim = xy.contiguous(), face_index_map.contiguous()
    ga = grad_alpha.contiguous() if settings.return_alpha else None
    ptr = _build.ptr
    _build.launch(_build.library('backward_sweeps'), name,
                  xy.get_device(), xy.data_ptr(), fim.data_ptr(), ptr(rgb),
                  _strides(rgb), ptr(grad_rgb), _strides(grad_rgb), ptr(ga),
                  bs, is_, settings.eps, out.data_ptr(), out.stride(0),
                  *extra)
    return out


def _plain_maps(settings, xy, face_index_map):
    ppx, ppy = bwd.pixel_coords(xy, settings.image_size)
    covered = face_index_map >= 0
    alpha = covered.to(torch.float32) if settings.return_alpha else None
    return ppx, ppy, covered, alpha


def insweep_plain(settings, xy, face_index_map, rgb=None, grad_rgb=None,
                  grad_alpha=None):
    """The plain PyTorch version of ``insweep``."""
    ppx, ppy, covered, alpha = _plain_maps(settings, xy, face_index_map)
    return bwd.insweep_channels(settings, ppx, ppy, covered, rgb, grad_rgb,
                                alpha, grad_alpha)


def outsweep_plain(settings, xy, face_index_map, rgb=None, grad_rgb=None,
                   grad_alpha=None):
    """The plain PyTorch version of ``outsweep`` (row-chunked dense
    sweep, O(bs * is^3))."""
    ppx, ppy, covered, alpha = _plain_maps(settings, xy, face_index_map)
    return bwd.outsweep_channels(settings, ppx, ppy, covered, rgb, grad_rgb,
                                 alpha, grad_alpha)


def insweep(settings, xy, face_index_map, rgb=None, grad_rgb=None,
            grad_alpha=None, out=None):
    """K5 in-sweep channels ``[bs, 12, is, is]`` (written into ``out``
    when given: a ``[bs, 12, is, is]`` view with dense planes)."""
    _check_sweep_inputs(settings, xy, face_index_map, rgb, grad_rgb,
                        grad_alpha)
    bs, is_ = face_index_map.shape[0], settings.image_size
    if out is not None:
        _check_out(out, bs, is_)
    if not on_card(xy):
        res = insweep_plain(settings, xy, face_index_map, rgb, grad_rgb,
                            grad_alpha)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((bs, 12, is_, is_), dtype=torch.float32,
                          device=xy.device)
    return _launch_sweep('insweep', settings, xy, face_index_map, rgb,
                         grad_rgb, grad_alpha, out)


def outsweep(settings, xy, face_index_map, rgb=None, grad_rgb=None,
             grad_alpha=None, out=None, accumulate=False):
    """K5 out-sweep channels ``[bs, 12, is, is]``.  With ``out`` (a
    ``[bs, 12, is, is]`` view with dense planes) the result is written
    there, or with ``accumulate`` added to it (``out + sweep``, as the JAX
    package adds the out-sweep to the in-sweep).  The kernel takes any
    line length: a line's crossing list is swept in rounds where it
    outgrows shared memory, and a line's planes are read from device memory
    where they do not fit there (``outsweep_plan``)."""
    return _outsweep(settings, xy, face_index_map, rgb, grad_rgb,
                     grad_alpha, out, accumulate)


def _outsweep(settings, xy, face_index_map, rgb, grad_rgb, grad_alpha, out,
              accumulate, cap=None, staged=None):
    """``outsweep``, whose kernel launch may be given the crossing list's
    capacity ``cap`` and where its planes live, ``staged``
    (``outsweep_plan``)."""
    _check_sweep_inputs(settings, xy, face_index_map, rgb, grad_rgb,
                        grad_alpha)
    bs, is_ = face_index_map.shape[0], settings.image_size
    if out is not None:
        _check_out(out, bs, is_)
    elif accumulate:
        raise ValueError('accumulate needs out')
    if not on_card(xy):
        res = outsweep_plain(settings, xy, face_index_map, rgb, grad_rgb,
                             grad_alpha)
        if out is None:
            return res
        return out.add_(res) if accumulate else out.copy_(res)
    if out is None:
        out = torch.empty((bs, 12, is_, is_), dtype=torch.float32,
                          device=xy.device)
    plan = outsweep_plan(is_, settings.return_rgb, settings.return_alpha,
                         _smem_limit(xy.get_device()), cap, staged)
    return _launch_sweep('outsweep', settings, xy, face_index_map, rgb,
                         grad_rgb, grad_alpha, out, int(accumulate),
                         int(plan['staged']), plan['cap'])


# the largest cube whose K6 factors the reduction builds (the kernel's
# kMaxTs, 23 factors at ts 4); larger cubes take the 8-corner scatter, as in
# the JAX package
MAX_FACTOR_TS = 4


class K6Maps(typing.NamedTuple):
    """What the K6 texture factors of a ``ts`` cube are built from at each
    covered pixel (``texture.texture_cell_factors``): the forward's maps
    and the rgb gradient, as the backward holds them."""

    settings: object          # the rasterizer's settings: eps sets the clamp
    ts: int
    z: torch.Tensor           # [bs, 3, is, is], the winner's vertex depths
    weights: torch.Tensor     # [bs, 3, is, is]
    depth_map: torch.Tensor   # [bs, is, is]
    grad_rgb: torch.Tensor    # [bs, is, is, 3], any strides

    def factors(self, face_index_map):
        """The factor channels ``[bs, ts^2 + ts + 3, is, is]`` in plain
        torch, zero at uncovered pixels."""
        return tex.texture_cell_factors(
            self.settings, face_index_map, self.z.permute(0, 2, 3, 1),
            self.weights.permute(0, 2, 3, 1), self.depth_map,
            self.grad_rgb.permute(0, 3, 1, 2), self.ts)


def face_reduce_plain(stack, face_index_map, nf, k6=None):
    """The plain PyTorch version of ``face_reduce``: the K6 factors built
    from ``k6``'s maps and expanded to texture cells
    (``texture.texture_channels_cells``) after the stack's channels, then
    ``index_add_`` of the pixel rows over ``bs * nf + 1`` segments, the
    overflow row dropped."""
    bs = stack.shape[0]
    if k6 is not None:
        stack = torch.cat([stack, tex.texture_channels_cells(
            k6.factors(face_index_map), k6.ts)], dim=1)
    c_out = stack.shape[1]
    rows = stack.permute(0, 2, 3, 1).reshape(-1, c_out)
    seg = bwd.face_segments(face_index_map, nf).reshape(-1)
    out = torch.zeros((bs * nf + 1, c_out), dtype=torch.float32,
                      device=stack.device)
    return out.index_add_(0, seg, rows)[:-1]


def _check_k6(k6, bs, is_, device):
    """``k6``'s cube size and maps (any strides) as the kernel takes them."""
    if not 1 <= k6.ts <= MAX_FACTOR_TS:
        raise ValueError(f'the reduction builds the K6 factors of 1 <= ts <= '
                         f'{MAX_FACTOR_TS}; got ts={k6.ts}')
    want = {'z': (bs, 3, is_, is_), 'weights': (bs, 3, is_, is_),
            'depth_map': (bs, is_, is_), 'grad_rgb': (bs, is_, is_, 3)}
    for name, shape in want.items():
        t = getattr(k6, name)
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != device):
            raise ValueError(f'k6.{name} must be float32 {shape} on '
                             f'{device}; got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')


def _k6_args(k6):
    """The kernel's K6 arguments: the maps' device addresses, their 4
    element strides each (depth as ``[bs, 1, is, is]``, the rgb gradient
    as its ``[bs, 3, is, is]`` permutation), and the clamp's upper limit
    ``ts - 1 - eps`` as torch.clamp rounds it, to float; nulls where there
    are no factors."""
    if k6 is None:
        return None, None, 0.0
    maps = (k6.z, k6.weights, k6.depth_map[:, None],
            k6.grad_rgb.permute(0, 3, 1, 2))
    return ((_build.PTR * 4)(*(t.data_ptr() for t in maps)),
            (_build.I64 * 16)(*(n for t in maps for n in t.stride())),
            k6.ts - 1 - k6.settings.eps)


def face_reduce(stack, face_index_map, nf, k6=None, bins=None):
    """Per-face sums ``[bs * nf, C_out]`` over the pixels each face won of
    the channel stack ``[bs, C, is, is]`` (the K5 and K7 channels; ``C``
    may be 0) and, with ``k6`` (``K6Maps`` of a ``ts`` cube), of the K6
    texture cells: the factors built from ``k6``'s maps
    (``texture.texture_cell_factors``), expanded to ``ts^3 * 3`` cell
    columns in cube order after the stack's, so ``C_out = C + 3 ts^3``.
    Faces that win no pixel get exact zeros; uncovered pixels are skipped.

    ``bins``: the forward's tile lists (``forward_shaded(...)['bins']``:
    ``tile``, ``start``, ``ids``, ``order``, ``first``), which hold every
    covered pixel's winner.  Required on the card, where the kernel sums
    each (tile, face) pair and then each face's pairs, deterministically
    (no float atomics, no sort of the raster), and builds the factors of
    each covered pixel in its tile pass from the maps, with no factor
    planes; ignored on the CPU.  On the card a reduction with ``k6`` counts
    one ``k6.in_reduce`` and the texture cells it writes, ``bs * nf *
    ts^3``, as ``work.k6_cells``."""
    bs, C, is_ = stack.shape[0], stack.shape[1], stack.shape[2]
    if (stack.dtype != torch.float32 or stack.ndim != 4
            or stack.shape[3] != is_
            or tuple(face_index_map.shape) != (bs, is_, is_)
            or face_index_map.dtype != torch.int32):
        raise ValueError('stack must be float32 [bs, C, is, is] and '
                         'face_index_map int32 [bs, is, is]; got '
                         f'{stack.dtype} {tuple(stack.shape)} and '
                         f'{face_index_map.dtype} '
                         f'{tuple(face_index_map.shape)}')
    if k6 is not None:
        _check_k6(k6, bs, is_, stack.device)
    if not on_card(stack):
        return face_reduce_plain(stack, face_index_map, nf, k6)
    if bs * is_ * is_ >= 2 ** 31 or bs * nf >= 2 ** 31:
        raise ValueError('face_reduce indexes pixels and faces with int32')
    lib = _build.library('face_reduce')
    config.check_bins(bins, bs, nf, is_, lib.nr_face_reduce_tile(),
                      stack.device, 'face_reduce')
    ts = 0 if k6 is None else k6.ts
    stack = stack.contiguous()
    fim = face_index_map.contiguous()
    c_out = C + 3 * ts ** 3
    partial = torch.empty((bins['ids'].shape[0], c_out), dtype=torch.float32,
                          device=stack.device)
    out = torch.empty((bs * nf, c_out), dtype=torch.float32,
                      device=stack.device)
    _build.launch(
        lib, 'face_reduce', stack.get_device(), stack.data_ptr(),
        fim.data_ptr(),
        *(bins[k].data_ptr() for k in ('start', 'ids', 'order', 'first')),
        bs, nf, is_, C, ts, *_k6_args(k6), partial.data_ptr(),
        out.data_ptr())
    if ts:
        tracing.COUNTS['k6.in_reduce'] += 1
        tracing.COUNTS['work.k6_cells'] += bs * nf * ts ** 3
    return out


def face_grad_plain(sums, face_shape, k5, k7_off=None):
    """The plain PyTorch version of ``face_grad``: each K5 slot's two sums
    (``backward.K5_SLOTS``) added onto zeros, then the K7 columns added."""
    grad = torch.zeros((sums.shape[0], 9), dtype=torch.float32,
                       device=sums.device)
    if k5:
        for slot, c0, c1 in bwd.K5_SLOTS:
            grad[:, slot].add_(sums[:, c0] + sums[:, c1])
    if k7_off is not None:
        grad.add_(sums[:, k7_off:k7_off + 9])
    return grad.reshape(face_shape)


def face_grad(sums, face_shape, k5, k7_off=None):
    """``grad_faces`` ``face_shape = (bs, nf, 3, 3)``, float32 and
    contiguous, from the per-face sums ``[bs * nf, C_out]`` of
    ``face_reduce``.  ``k5``: columns 0-11 hold the K5 sums, added in their
    vertex slots (``backward.K5_SLOTS``; the z slots get none); ``k7_off``:
    the first of the 9 K7 columns (slot order), added after, or None.
    Entry (v, c < 2) is ``(0 + (c0 + c1)) + k7`` and entry (v, 2) ``0 +
    k7``, the terms present as asked; the leading ``0 +`` turns -0 into +0.

    A CUDA tensor launches the kernel (``csrc/face_reduce.cu``, one pass,
    counted as ``tracing.COUNTS['launch.face_grad']``) into a new tensor, or
    raises; a CPU tensor runs ``face_grad_plain``.  Both give the same
    bits."""
    face_shape = tuple(face_shape)
    if len(face_shape) != 4 or face_shape[2:] != (3, 3):
        raise ValueError(f'face_shape must be (bs, nf, 3, 3); got '
                         f'{face_shape}')
    n = face_shape[0] * face_shape[1]
    width = max(12 if k5 else 0, 0 if k7_off is None else k7_off + 9)
    if (sums.dtype != torch.float32 or sums.ndim != 2
            or sums.shape[0] != n or sums.shape[1] < width
            or (sums.shape[1] > 1 and sums.stride(1) != 1)):
        raise ValueError(f'sums must be float32 [{n}, >= {width}] with '
                         f'unit column stride; got {sums.dtype} '
                         f'{tuple(sums.shape)} strides {sums.stride()}')
    if k7_off is not None and k7_off < 0:
        raise ValueError(f'k7_off must be None or >= 0; got {k7_off}')
    if not on_card(sums):
        return face_grad_plain(sums, face_shape, k5, k7_off)
    out = torch.empty(face_shape, dtype=torch.float32, device=sums.device)
    if n == 0:
        return out
    _build.launch(_build.library('face_reduce'), 'face_grad',
                  sums.get_device(), sums.data_ptr(), sums.stride(0), n,
                  int(k5), -1 if k7_off is None else k7_off, out.data_ptr())
    return out
