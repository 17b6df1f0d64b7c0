"""Binned shaded forward: the hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ``forward_pallas.forward_shaded``.  One call
produces, per pixel of each batch row, the winning face (lowest id among the
front faces with the strictly smallest perspective depth, the reference's
first-wins rule, rasterize.py:334), its renormalized barycentric weights and
depth, its NDC vertex coordinates, and the K4 trilinear texture colour for
texture cubes with ``ts <= 4`` (reference rasterize.py:398-425).

The per-face precompute and the binning are plain PyTorch, as the JAX package
does them in XLA (``forward_pallas._feature_table``, ``_face_tile_ranges``):

  * ``_face_records``: per face its NDC ``x0 y0 x1 y1 x2 y2``, ``z0 z1 z2``
    and the barycentric matrix face_inv, zeroed where it is not finite
    (degenerate faces: their weights are then 0 and their depth ``0/0``,
    which the z test rejects);
  * ``bin_faces``: every front face goes to each screen tile its
    conservative pixel bbox (``+-1`` pad) overlaps, in ascending face order,
    as CSR lists (``start`` offsets + face ``ids``).

The kernel (``csrc/forward_shaded.cu``) renders one tile per block and loops
over any list length, so there is no capacity limit and nothing to tune.

``forward_shaded`` sends a CUDA tensor to the kernel (or raises) and a CPU
tensor to ``forward_shaded_plain``, the dense version built from
``forward_dense`` and ``texture.sample_textures``.
"""

import ctypes
import functools

import torch

from neural_renderer_torch import _build
from neural_renderer_torch.rasterize import forward_dense, geometry
from neural_renderer_torch.rasterize import texture as tex

# Kernel launches since import (or since a caller reset it): one per launch
# of the CUDA kernel, never for the plain version.
LAUNCHES = 0

# the kernel shades cubes up to ts=4 (the reference Mesh default,
# reference mesh.py:21); bigger cubes are sampled after it, as in the JAX
# package (core.py:208)
MAX_FUSED_TS = 4


@functools.cache
def _kernel():
    """The kernel library, built at first use, with its C signatures."""
    lib = _build.load('forward_shaded')
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nr_forward_shaded.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, f32, f32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.nr_forward_shaded.restype = i32
    lib.nr_forward_shaded_tile.argtypes = []
    lib.nr_forward_shaded_tile.restype = i32
    lib.nr_error_string.argtypes = [i32]
    lib.nr_error_string.restype = ctypes.c_char_p
    return lib


def _face_records(settings, faces):
    """Per-face records ``[bs, nf, 18]``: NDC xy of the 3 vertices, z0-2,
    face_inv rows (non-finite entries zeroed)."""
    bs, nf = faces.shape[:2]
    is_ = settings.image_size
    finv = geometry.face_inv_matrix(
        geometry.to_pixel_coords(faces[..., 0], is_),
        geometry.to_pixel_coords(faces[..., 1], is_))
    finv = torch.where(torch.isfinite(finv), finv, torch.zeros_like(finv))
    return torch.cat([faces[..., 0:2].reshape(bs, nf, 6), faces[..., 2],
                      finv.reshape(bs, nf, 9)], dim=-1).contiguous()


def _face_tile_ranges(settings, faces, tile):
    """Per-face tile rectangle [ty0, ty1] x [tx0, tx1] (int64) + front mask.

    Conservative pixel bbox: pixel centers sit at integer pixel-space
    coords, and the +-1 pad absorbs rounding of the edge tests
    (``forward_pallas._face_tile_ranges``).  Empty ranges (and NaN faces)
    get ``t1 = t0 - 1``.
    """
    is_ = settings.image_size
    nt = -(-is_ // tile)
    front = geometry.is_frontface(faces)
    px = geometry.to_pixel_coords(faces[..., 0], is_)
    py = geometry.to_pixel_coords(faces[..., 1], is_)

    def rng(lo, hi):
        t0 = torch.clamp(torch.floor(lo / tile), 0, nt - 1)
        t1 = torch.clamp(torch.floor(hi / tile), 0, nt - 1)
        hits = (hi >= 0) & (lo <= is_ - 1)     # False for NaN
        t0 = torch.where(hits, t0, torch.zeros_like(t0)).long()
        t1 = torch.where(hits, t1, torch.full_like(t1, -1.0)).long()
        return t0, t1

    ty0, ty1 = rng(torch.floor(py.amin(-1)) - 1.0,
                   torch.ceil(py.amax(-1)) + 1.0)
    tx0, tx1 = rng(torch.floor(px.amin(-1)) - 1.0,
                   torch.ceil(px.amax(-1)) + 1.0)
    return front, ty0, ty1, tx0, tx1


def bin_faces(settings, faces, tile):
    """CSR tile lists: (start [bs*nt*nt + 1] int32, ids [total] int32).

    Tile ``(b, ty, tx)`` (row-major, ``nt = ceil(is / tile)``) holds the
    front faces ``ids[start[t]:start[t + 1]]`` in ascending order.  Reading
    the list total back to the host syncs the device once.
    """
    bs, nf = faces.shape[:2]
    nt = -(-settings.image_size // tile)
    dev = faces.device
    front, ty0, ty1, tx0, tx1 = _face_tile_ranges(settings, faces, tile)
    ny = (ty1 - ty0 + 1).clamp(min=0)
    nx = (tx1 - tx0 + 1).clamp(min=0)
    n = torch.where(front, ny * nx, torch.zeros_like(ny)).reshape(-1)
    total = int(n.sum())
    if total >= 2 ** 31:
        raise ValueError(f'{total} (tile, face) pairs overflow int32 offsets')
    # one entry per (face, covered tile), faces ascending
    fid = torch.repeat_interleave(torch.arange(bs * nf, device=dev), n,
                                  output_size=total)
    j = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[fid]
    nxf = nx.reshape(-1)[fid]
    ty = ty0.reshape(-1)[fid] + torch.div(j, nxf, rounding_mode='floor')
    tx = tx0.reshape(-1)[fid] + j % nxf
    key = ((fid // nf) * nt + ty) * nt + tx
    # a stable sort keeps each tile's faces in ascending id order
    order = torch.sort(key, stable=True).indices
    ids = (fid[order] % nf).to(torch.int32)
    start = torch.zeros(bs * nt * nt + 1, dtype=torch.int32, device=dev)
    start[1:] = torch.cumsum(torch.bincount(key, minlength=bs * nt * nt), 0)
    return start, ids


def _check(settings, faces, textures):
    if faces.dtype != torch.float32 or faces.ndim != 4 \
            or faces.shape[2:] != (3, 3):
        raise ValueError('faces must be float32 [bs, nf, 3, 3]; got '
                         f'{faces.dtype} {tuple(faces.shape)}')
    if textures is None:
        return
    ts = textures.shape[2]
    if (textures.dtype != torch.float32 or textures.ndim != 6
            or textures.shape[:2] != faces.shape[:2]
            or textures.shape[2:] != (ts, ts, ts, 3)):
        raise ValueError('textures must be float32 [bs, nf, ts, ts, ts, 3] '
                         f'matching faces; got {textures.dtype} '
                         f'{tuple(textures.shape)}')
    if textures.device != faces.device:
        raise ValueError('faces and textures must be on one device')


def forward_shaded(settings, faces, textures=None):
    """Shaded forward maps for NDC ``faces [bs, nf, 3, 3]``.

    Returns dict face_index_map [bs,is,is] int32 (-1 uncovered), depth_map
    [bs,is,is] (``far`` uncovered), weights [bs,3,is,is], xy [bs,6,is,is]
    (the winner's NDC x0 y0 x1 y1 x2 y2), z [bs,3,is,is], and rgb
    [bs,3,is,is] (uncomposited) when ``textures`` [bs,nf,ts,ts,ts,3] is
    given; zeros where uncovered.

    A CUDA tensor runs the kernel, which shades ``2 <= ts <= 4`` (a larger
    cube is shaded by ``texture.sample_textures`` after this call, as in the
    JAX package); a CPU tensor runs ``forward_shaded_plain``.
    """
    global LAUNCHES
    _check(settings, faces, textures)
    if faces.device.type == 'cpu':
        return forward_shaded_plain(settings, faces, textures)
    if faces.device.type != 'cuda':
        raise ValueError(f'no forward for device {faces.device}')
    ts = 0 if textures is None else textures.shape[2]
    if textures is not None and not 2 <= ts <= MAX_FUSED_TS:
        raise ValueError(f'the kernel shades 2 <= ts <= {MAX_FUSED_TS}; '
                         f'got ts={ts}')

    lib = _kernel()
    bs, nf = faces.shape[:2]
    is_ = settings.image_size
    faces = faces.contiguous()
    rec = _face_records(settings, faces)
    start, ids = bin_faces(settings, faces, lib.nr_forward_shaded_tile())
    texc = None if textures is None else textures.contiguous()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=faces.device)

    out = dict(face_index_map=empty(bs, is_, is_, dtype=torch.int32),
               depth_map=empty(bs, is_, is_), weights=empty(bs, 3, is_, is_),
               xy=empty(bs, 6, is_, is_), z=empty(bs, 3, is_, is_))
    if textures is not None:
        out['rgb'] = empty(bs, 3, is_, is_)

    def ptr(t):
        return None if t is None else t.data_ptr()

    tif_max = ts - 1 - settings.eps
    with torch.cuda.device(faces.device):
        rc = lib.nr_forward_shaded(
            ptr(rec), ptr(start), ptr(ids), ptr(texc), bs, nf, is_, ts,
            settings.near, settings.far, tif_max,
            ptr(out['face_index_map']), ptr(out['depth_map']),
            ptr(out['weights']), ptr(out['xy']), ptr(out['z']),
            ptr(out.get('rgb')),
            torch.cuda.current_stream(faces.device).cuda_stream)
    if rc != 0:
        raise RuntimeError('forward_shaded kernel launch failed: '
                           + lib.nr_error_string(rc).decode())
    LAUNCHES += 1
    return out


def forward_shaded_plain(settings, faces, textures=None):
    """The plain PyTorch version of ``forward_shaded``: the same dict from
    the dense oracle, the winner's attributes and K4 sampling (any ts)."""
    bs = faces.shape[0]
    is_ = settings.image_size
    fim, _ = forward_dense.forward_face_index_map(settings, faces)
    face_w = forward_dense.gather_face_rows(faces, fim)
    weight_map, depth_map = forward_dense.winner_attributes(settings, fim,
                                                            face_w)
    covered = (fim >= 0)[..., None, None]
    face_w0 = torch.where(covered, face_w, torch.zeros_like(face_w))
    out = dict(
        face_index_map=fim,
        depth_map=depth_map,
        weights=weight_map.permute(0, 3, 1, 2).contiguous(),
        xy=face_w0[..., 0:2].reshape(bs, is_, is_, 6).permute(
            0, 3, 1, 2).contiguous(),
        z=face_w0[..., 2].permute(0, 3, 1, 2).contiguous())
    if textures is not None:
        rgb = tex.sample_textures(settings, textures, fim, face_w[..., 2],
                                  weight_map, depth_map)
        out['rgb'] = rgb.permute(0, 3, 1, 2).contiguous()
    return out
