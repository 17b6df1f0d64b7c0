"""The backward's CUDA kernels and their plain versions.

Three hand-written kernels carry the rasterizer's approximate backward on
the card:

  * ``insweep`` (``csrc/backward_sweeps.cu``, replaces the TPU kernel
    ``backward_pallas._kernel``): the K5 in-sweep, ``[bs, 12, is, is]``;
  * ``outsweep`` (same source, replaces ``backward_pallas.
    _outsweep_kernel``): the K5 out-sweep, ``[bs, 12, is, is]``, written or
    added to the in-sweep's channels;
  * ``face_reduce`` (``csrc/face_reduce.cu``, replaces ``backward_pallas.
    _csr_kernel`` and its segment_sum): per-face sums of the fused
    per-pixel channel stack, K6 factors expanded to texture cells, per
    (tile, face) pair of the forward's tile lists and then per face.

Each wrapper sends a CPU tensor to its plain PyTorch version
(``insweep_plain``, ``outsweep_plain``, ``face_reduce_plain``) and a CUDA
tensor to its kernel, which it launches or raises; any other device raises.
``LAUNCHES`` counts kernel launches per kernel, never plain-version calls.

The sweeps read the forward's maps as the CUDA forward writes them: ``xy``
``[bs, 6, is, is]`` (the winner's NDC x0 y0 x1 y1 x2 y2), ``face_index_map``
``[bs, is, is]`` int32, and value/gradient planes ``rgb``, ``grad_rgb``
``[bs, 3, is, is]`` (the *composited* rgb; any strides, so the permuted
NHWC maps go in as they are) and ``grad_alpha`` ``[bs, is, is]``.  Alpha
is the coverage of ``face_index_map``.  Which terms enter follows
``settings.return_rgb`` / ``return_alpha``.
"""

import ctypes
import functools

import torch

from neural_renderer_torch import _build
from neural_renderer_torch.rasterize import backward as bwd
from neural_renderer_torch.rasterize import texture as tex
from neural_renderer_torch.rasterize.config import on_card

# Kernel launches since import (or since a caller reset them), per kernel.
LAUNCHES = {'insweep': 0, 'outsweep': 0, 'face_reduce': 0}


@functools.cache
def _sweeps():
    """The sweep kernels' library, built at first use."""
    lib = _build.load('backward_sweeps')
    ptr, i32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_longlong)
    strides = ctypes.POINTER(i64)
    common = [ptr, ptr, ptr, strides, ptr, strides, ptr, i32, i32, f32, ptr,
              i64]
    lib.nr_insweep.argtypes = common + [ptr]
    lib.nr_insweep.restype = i32
    lib.nr_outsweep.argtypes = common + [i32, i32, i32, ptr]
    lib.nr_outsweep.restype = i32
    lib.nr_outsweep_smem_limit.argtypes = []
    lib.nr_outsweep_smem_limit.restype = i32
    lib.nr_error_string.argtypes = [i32]
    lib.nr_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _reduce():
    """The face-reduction kernels' library, built at first use."""
    lib = _build.load('face_reduce')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nr_face_reduce.argtypes = [ptr] * 6 + [i32] * 5 + [ptr] * 3
    lib.nr_face_reduce.restype = i32
    lib.nr_face_reduce_tile.argtypes = []
    lib.nr_face_reduce_tile.restype = i32
    lib.nr_error_string.argtypes = [i32]
    lib.nr_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = _sweeps()
    with torch.cuda.device(device_index):
        limit = lib.nr_outsweep_smem_limit()
    if limit <= 0:
        _build.raise_on_error(lib, -limit, 'smem query')
    return limit


def _device_index(t):
    return (t.device.index if t.device.index is not None
            else torch.cuda.current_device())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(t):
    """A map's 4 element strides as a C array (None for no map)."""
    return None if t is None else (ctypes.c_longlong * 4)(*t.stride())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
    lib = _sweeps()
    bs, is_ = face_index_map.shape[0], settings.image_size
    if not settings.return_rgb:
        rgb = grad_rgb = None
    xy, fim = xy.contiguous(), face_index_map.contiguous()
    ga = grad_alpha.contiguous() if settings.return_alpha else None
    with torch.cuda.device(xy.device):
        rc = getattr(lib, f'nr_{name}')(
            xy.data_ptr(), fim.data_ptr(), _ptr(rgb), _strides(rgb),
            _ptr(grad_rgb), _strides(grad_rgb), _ptr(ga), bs, is_,
            settings.eps, out.data_ptr(), out.stride(0), *extra, _stream(xy))
    _build.raise_on_error(lib, rc, name)
    LAUNCHES[name] += 1
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
                         _smem_limit(_device_index(xy)), cap, staged)
    return _launch_sweep('outsweep', settings, xy, face_index_map, rgb,
                         grad_rgb, grad_alpha, out, int(accumulate),
                         int(plan['staged']), plan['cap'])


def _expanded_width(C, ts):
    """Output columns of a C-channel stack whose last ts^2 + ts + 3
    channels are K6 factors (none when ts is 0)."""
    if not ts:
        return C
    naux = ts * ts + ts + 3
    if C < naux:
        raise ValueError(f'a stack of {C} channels cannot carry the {naux} '
                         f'K6 factor channels of ts={ts}')
    return C - naux + ts ** 3 * 3


def face_reduce_plain(stack, face_index_map, nf, ts=0):
    """The plain PyTorch version of ``face_reduce``: expand the K6 factors
    (``texture.texture_channels_cells``), then ``index_add_`` the pixel rows
    over ``bs * nf + 1`` segments and drop the overflow row."""
    bs, C = stack.shape[:2]
    c_out = _expanded_width(C, ts)
    if ts:
        naux = ts * ts + ts + 3
        stack = torch.cat([stack[:, :C - naux],
                           tex.texture_channels_cells(stack[:, C - naux:],
                                                      ts)], dim=1)
    rows = stack.permute(0, 2, 3, 1).reshape(-1, c_out)
    seg = bwd.face_segments(face_index_map, nf).reshape(-1)
    out = torch.zeros((bs * nf + 1, c_out), dtype=torch.float32,
                      device=stack.device)
    return out.index_add_(0, seg, rows)[:-1]


def _check_bins(bins, bs, nf, is_, tile, device):
    """The forward's tile lists (``forward_cuda.bin_faces`` at the kernel's
    tile size): int32 tensors on ``device`` of matching lengths."""
    if bins is None:
        raise ValueError('face_reduce on the card needs bins, the forward\'s '
                         'tile lists (forward_shaded(...)["bins"])')
    if bins['tile'] != tile:
        raise ValueError(f'bins were made for {bins["tile"]}-pixel tiles; '
                         f'the kernel reduces {tile}-pixel tiles')
    nt = -(-is_ // tile)
    pairs = bins['ids'].shape[0]
    want = {'start': bs * nt * nt + 1, 'ids': pairs, 'order': pairs,
            'first': bs * nf + 1}
    for name, length in want.items():
        t = bins[name]
        if (t.dtype != torch.int32 or tuple(t.shape) != (length,)
                or t.device != device):
            raise ValueError(f'bins[{name!r}] must be int32 ({length},) on '
                             f'{device}; got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')


def face_reduce(stack, face_index_map, nf, ts=0, bins=None):
    """Per-face sums ``[bs * nf, C_out]`` of the channel stack
    ``[bs, C, is, is]`` over the pixels each face won.  With ``ts`` > 0 the
    last ``ts^2 + ts + 3`` channels are K6 factors
    (``texture.texture_cell_factors``), expanded to ``ts^3 * 3`` cell
    columns in cube order, so ``C_out = C - (ts^2 + ts + 3) + ts^3 * 3``.
    Faces that win no pixel get exact zeros; uncovered pixels are skipped.

    ``bins``: the forward's tile lists (``forward_shaded(...)['bins']``:
    ``tile``, ``start``, ``ids``, ``order``, ``first``), which hold every
    covered pixel's winner.  Required on the card, where the kernel sums
    each (tile, face) pair and then each face's pairs, deterministically
    (no float atomics, no sort of the raster); ignored on the CPU."""
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
    c_out = _expanded_width(C, ts)
    if not on_card(stack):
        return face_reduce_plain(stack, face_index_map, nf, ts)
    if bs * is_ * is_ >= 2 ** 31 or bs * nf >= 2 ** 31:
        raise ValueError('face_reduce indexes pixels and faces with int32')
    lib = _reduce()
    _check_bins(bins, bs, nf, is_, lib.nr_face_reduce_tile(), stack.device)
    stack = stack.contiguous()
    fim = face_index_map.contiguous()
    partial = torch.empty((bins['ids'].shape[0], c_out), dtype=torch.float32,
                          device=stack.device)
    out = torch.empty((bs * nf, c_out), dtype=torch.float32,
                      device=stack.device)
    with torch.cuda.device(stack.device):
        rc = lib.nr_face_reduce(
            stack.data_ptr(), fim.data_ptr(),
            *(bins[k].data_ptr() for k in ('start', 'ids', 'order', 'first')),
            bs, nf, is_, C, ts, partial.data_ptr(), out.data_ptr(),
            _stream(stack))
    _build.raise_on_error(lib, rc, 'face_reduce')
    LAUNCHES['face_reduce'] += 1
    return out
