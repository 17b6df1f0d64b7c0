"""Binned forward: the hand-written CUDA kernels, their plain versions, and
the JAX package's scene counters.

``forward_shaded`` is the counterpart of the JAX package's
``forward_pallas.forward_shaded``.  One call produces, per pixel of each
batch row, the winning face (lowest id among the front faces with the
strictly smallest perspective depth, the reference's first-wins rule,
rasterize.py:334), its renormalized barycentric weights and depth, its NDC
vertex coordinates, and the K4 trilinear texture colour for texture cubes
with ``ts <= 4`` (reference rasterize.py:398-425).

``forward_face_index_map`` is the counterpart of
``forward_pallas.forward_face_index_map``: the winning face and the raw
minimum depth only (the quantity the z test compares), for ``tune`` and
``measure_scene``.

The per-face setup and the binning (the JAX package does them in XLA:
``forward_pallas._feature_table``, ``_face_tile_ranges``) are ``bin_setup``:
on a CUDA tensor the hand-written kernels of ``csrc/bin_faces.cu``, on a CPU
tensor ``bin_setup_plain``, built from

  * ``_face_records``: per face its NDC ``x0 y0 x1 y1 x2 y2``, ``z0 z1 z2``
    and the barycentric matrix face_inv, zeroed where it is not finite
    (degenerate faces: their weights are then 0 and their depth ``0/0``,
    which the z test rejects), the shaded kernel's record;
  * ``_index_records``: the index kernel's record, the same values with the
    edge differences, ``1/z`` and the pixel bbox made once per face;
  * ``bin_faces``: every front face goes to each screen tile its
    conservative pixel bbox (``+-1`` pad) overlaps, in ascending face order,
    as CSR lists (``start`` offsets + face ``ids``), with the pairs'
    face-major order (``order``, ``first``) for the backward's per-face
    reduction.

``coverage_masks`` and ``lists_from_masks`` are the plain versions of the
kernels' own steps (a 128-bit coverage mask per (tile, 128-face chunk),
one scan, O(1) ranks): the tests hold them to ``bin_faces``.

The kernels (``csrc/forward_shaded.cu``, ``csrc/forward_index.cu``) render
one tile per block and loop over any list length, so there is no capacity
limit and nothing to tune.  Each wrapper sends a CUDA tensor to its kernel
(or raises) and a CPU tensor to its plain version, built from
``forward_dense`` (and ``texture.sample_textures``).

The scene counters (``binning_overflow``, ``chunks_needed``,
``csr_rows_needed``, ``chunk_capacity``) give the JAX package's integers for
its Pallas forward's capacities, from its binning definitions (32-px
patches, 128-face chunks, 16,384-face slices); ``tune`` reports them.
"""

import functools

import torch

from neural_renderer_torch import _build, tracing
from neural_renderer_torch.rasterize import forward_dense, geometry
from neural_renderer_torch.rasterize import texture as tex
from neural_renderer_torch.rasterize.config import on_card

# faces per chunk of the JAX package's Pallas forward (forward_pallas.py:94);
# the port's kernels have no chunks, the scene counters count in them
_CHUNK = 128

# the kernel shades cubes up to ts=4 (the reference Mesh default,
# reference mesh.py:21); bigger cubes are sampled after it, as in the JAX
# package (core.py:208)
MAX_FUSED_TS = 4

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


def _index_records(settings, faces):
    """The index kernel's per-face records ``[bs, nf, 28]``: NDC ``x0 y0 x1
    y1 x2 y2``, the edge differences ``x1-x0 y1-y0 x2-x1 y2-y1 x0-x2
    y0-y2``, face_inv (as ``_face_records``), ``1/z0 1/z1 1/z2``, and the
    conservative pixel bbox of ``_face_tile_ranges``: rows ``floor(min py)
    - 1``, ``ceil(max py) + 1``, columns ``floor(min px) - 1``, ``ceil(max
    px) + 1``."""
    rec = _face_records(settings, faces)
    x, y = faces[..., 0], faces[..., 1]
    edges = torch.stack([x[..., 1] - x[..., 0], y[..., 1] - y[..., 0],
                         x[..., 2] - x[..., 1], y[..., 2] - y[..., 1],
                         x[..., 0] - x[..., 2], y[..., 0] - y[..., 2]], -1)
    bbox = []
    for v in (y, x):
        p = geometry.to_pixel_coords(v, settings.image_size)
        bbox += [torch.floor(p.amin(-1)) - 1.0, torch.ceil(p.amax(-1)) + 1.0]
    return torch.cat([rec[..., :6], edges, rec[..., 9:], 1.0 / faces[..., 2],
                      torch.stack(bbox, -1)], dim=-1).contiguous()


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


def _pairs(settings, faces, tile):
    """The (tile, face) pairs of ``faces`` at ``tile``, face-major (each
    face's tiles in row-major order): (n ``[bs, nf]`` pairs per face, first
    ``[bs * nf + 1]`` each face's first pair, fid, ty, tx ``[pairs]`` each
    pair's face of ``[bs * nf]`` and tile), int64."""
    bs, nf = faces.shape[:2]
    dev = faces.device
    front, ty0, ty1, tx0, tx1 = _face_tile_ranges(settings, faces, tile)
    ny = (ty1 - ty0 + 1).clamp(min=0)
    nx = (tx1 - tx0 + 1).clamp(min=0)
    n = torch.where(front, ny * nx, torch.zeros_like(ny))
    total = int(n.sum())
    if total >= 2 ** 31:
        raise ValueError(f'{total} (tile, face) pairs overflow int32 offsets')
    first = torch.zeros(bs * nf + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(n.reshape(-1), 0)
    fid = torch.repeat_interleave(torch.arange(bs * nf, device=dev),
                                  n.reshape(-1), output_size=total)
    j = torch.arange(total, device=dev) - first[fid]
    nxf = nx.reshape(-1)[fid]
    ty = ty0.reshape(-1)[fid] + torch.div(j, nxf, rounding_mode='floor')
    tx = tx0.reshape(-1)[fid] + j % nxf
    return n, first, fid, ty, tx


def bin_faces(settings, faces, tile):
    """CSR tile lists: (start [bs*nt*nt + 1], ids [pairs], order [pairs],
    first [bs*nf + 1]), all int32.

    Tile ``(b, ty, tx)`` (row-major, ``nt = ceil(is / tile)``) holds the
    front faces ``ids[start[t]:start[t + 1]]`` in ascending order.  The
    (tile, face) pairs are made face-major (each face's tiles in row-major
    order) and sorted tile-major: tile-major pair ``i`` is face-major pair
    ``order[i]``, and face ``s`` of ``[bs * nf]`` owns the face-major pairs
    ``first[s]:first[s + 1]``.  Reading the pair total back to the host
    syncs the device once.
    """
    bs, nf = faces.shape[:2]
    nt = -(-settings.image_size // tile)
    _, first, fid, ty, tx = _pairs(settings, faces, tile)
    key = ((fid // nf) * nt + ty) * nt + tx
    # a stable sort keeps each tile's faces in ascending id order
    order = torch.sort(key, stable=True).indices
    ids = (fid[order] % nf).to(torch.int32)
    start = torch.zeros(bs * nt * nt + 1, dtype=torch.int32,
                        device=faces.device)
    start[1:] = torch.cumsum(torch.bincount(key, minlength=bs * nt * nt), 0)
    return start, ids, order.to(torch.int32), first.to(torch.int32)


# faces per chunk of csrc/bin_faces.cu: one block, one 128-bit coverage
# mask per (tile, chunk) cell
BIN_CHUNK = 128


def _popcount(x):
    """Set bits of each int64 entry of ``x`` below 2^32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def coverage_masks(settings, faces, tile):
    """The plain version of the count pass of ``csrc/bin_faces.cu``: (count
    ``[bs, nf]`` pairs per face, box ``[bs, nch, 4]`` each chunk of
    ``BIN_CHUNK`` faces' tile bbox ``ty0 ty1 tx0 tx1`` over its faces with
    pairs, ``0 -1 0 -1`` where it has none, mask ``[bs, T, nch, 4]`` the
    coverage masks, bit ``l`` of word ``w`` for face ``BIN_CHUNK * c + 32 w
    + l`` of chunk ``c``), int64, ``T = nt * nt``.  Every bit lies inside
    its chunk's box."""
    bs, nf = faces.shape[:2]
    nt = -(-settings.image_size // tile)
    nch = -(-nf // BIN_CHUNK)
    dev = faces.device
    n, _, fid, ty, tx = _pairs(settings, faces, tile)
    _, ty0, ty1, tx0, tx1 = _face_tile_ranges(settings, faces, tile)
    live = n > 0
    pad = nch * BIN_CHUNK - nf

    def chunked(v, empty, reduce):
        v = torch.where(live, v, torch.full_like(v, empty))
        v = torch.nn.functional.pad(v, (0, pad), value=empty)
        return reduce(v.reshape(bs, nch, BIN_CHUNK), -1)

    big = 2 ** 31
    box = torch.stack([chunked(ty0, big, torch.amin),
                       chunked(ty1, -big, torch.amax),
                       chunked(tx0, big, torch.amin),
                       chunked(tx1, -big, torch.amax)], -1)
    none = (box[..., 0] > box[..., 1])[..., None]
    box = torch.where(none, torch.tensor([0, -1, 0, -1], device=dev), box)
    b, f = fid // nf, fid % nf
    word = (((b * nt + ty) * nt + tx) * nch + f // BIN_CHUNK) * 4 \
        + (f % BIN_CHUNK) // 32
    mask = torch.zeros(bs * nt * nt * nch * 4, dtype=torch.int64, device=dev)
    # each (face, tile) pair sets its bit once, so the sum is the OR
    mask.index_add_(0, word, torch.ones_like(word) << (f % 32))
    return n, box, mask.reshape(bs, nt * nt, nch, 4)


def lists_from_masks(settings, faces, tile, count, box, mask):
    """The plain version of the scan and fill passes of ``csrc/bin_faces.cu``:
    ``bin_faces``' (start, ids, order, first) from ``coverage_masks``.  The
    scan runs over the faces' pair counts, then each cell's popcount (0
    outside its chunk's box, where ``mask`` is never read); a pair's slot is
    its cell's scan entry less the pair total, plus the popcount of its
    cell's bits below its face's."""
    bs, nf = faces.shape[:2]
    nt = -(-settings.image_size // tile)
    nch = box.shape[1]
    nseg = bs * nf
    _, _, fid, ty, tx = _pairs(settings, faces, tile)
    t = torch.arange(nt * nt, device=faces.device)
    tyy, txx = (t // nt)[None, :, None], (t % nt)[None, :, None]
    inside = ((tyy >= box[:, None, :, 0]) & (tyy <= box[:, None, :, 1])
              & (txx >= box[:, None, :, 2]) & (txx <= box[:, None, :, 3]))
    cells = torch.where(inside, _popcount(mask).sum(-1), 0)
    counts = torch.cat([count.reshape(-1), cells.reshape(-1)])
    scan = torch.cumsum(counts, 0) - counts
    total = int(scan[nseg])
    first = scan[:nseg + 1]
    start = torch.cat([scan[nseg::nch][:bs * nt * nt] - total,
                       scan.new_tensor([total])])
    b, f = fid // nf, fid % nf
    cell = ((b * nt + ty) * nt + tx) * nch + f // BIN_CHUNK
    words = mask.reshape(-1, 4)[cell]
    w, bit = (f % BIN_CHUNK) // 32, f % 32
    below = torch.arange(4, device=faces.device)[None, :] < w[:, None]
    rank = (_popcount(words.gather(1, w[:, None])[:, 0]
                      & ((torch.ones_like(bit) << bit) - 1))
            + torch.where(below, _popcount(words), 0).sum(-1))
    pos = scan[nseg + cell] - total + rank
    ids = torch.empty_like(f, dtype=torch.int32)
    order = torch.empty_like(f, dtype=torch.int32)
    ids[pos] = f.to(torch.int32)
    order[pos] = torch.arange(f.shape[0], dtype=torch.int32,
                              device=faces.device)
    return (start.to(torch.int32), ids, order, first.to(torch.int32))


def bin_setup(settings, faces, tile, records=('rec',)):
    """The per-face records and the tile lists of NDC ``faces [bs, nf, 3,
    3]`` at ``tile``: dict(tile, start, ids, order, first) of ``bin_faces``,
    plus ``rec`` (``_face_records``) and ``irec`` (``_index_records``) as
    ``records`` asks.

    A CUDA tensor runs the kernels of ``csrc/bin_faces.cu`` (counted once as
    ``tracing.COUNTS['launch.bin_faces']``) or raises; the pair total is
    read back to the host once (``wait.read.bin_total``), to size ``ids``
    and ``order``.  It also counts its work: ``work.faces`` (``bs * nf``),
    ``work.bin_pairs`` (the pair total) and ``work.bin_cells`` (the
    kernels' (tile, chunk) cells).  A CPU tensor runs ``bin_setup_plain``.
    """
    unknown = set(records) - {'rec', 'irec'}
    if unknown:
        raise ValueError(f'unknown records {sorted(unknown)}')
    if not on_card(faces):
        return bin_setup_plain(settings, faces, tile, records)
    with tracing.span('raster.bin_setup'):
        return _bin_setup(settings, faces, tile, records)


def _bin_setup(settings, faces, tile, records):
    """``bin_setup`` on the card."""
    faces = faces.contiguous()
    bs, nf = faces.shape[:2]
    nseg = bs * nf
    is_ = settings.image_size
    nt = -(-is_ // tile)
    lib = _build.library('bin_faces')
    dev = faces.device

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(tile=tile)
    for name, width in (('rec', 18), ('irec', 28)):
        if name in records:
            out[name] = empty(bs, nf, width, dtype=torch.float32)
    cells, temp_bytes = _bin_sizes(bs, nf, is_, tile)
    rect, count = empty(nseg, 4), empty(max(nseg, 1))
    box = empty(cells // (nt * nt) if cells else 0, 4)
    mask = empty(cells, 4)
    scan = empty(max(nseg + cells, 1), dtype=torch.int64)
    temp = empty(max(temp_bytes, 1), dtype=torch.uint8)
    out['first'] = empty(nseg + 1)
    out['start'] = empty(bs * nt * nt + 1)
    index = faces.get_device()
    _build.call(lib, 'nr_bin_count', index, faces.data_ptr(), bs, nf, is_,
                tile, _build.ptr(out.get('rec')), _build.ptr(out.get('irec')),
                rect.data_ptr(), count.data_ptr(), box.data_ptr(),
                mask.data_ptr(), scan.data_ptr(), temp.data_ptr(), temp_bytes)
    with tracing.wait('read', 'bin_total'):  # the forward's one sync
        total = int(scan[nseg])
    if total >= 2 ** 31:
        raise ValueError(f'{total} (tile, face) pairs overflow int32 offsets')
    out['ids'], out['order'] = empty(total), empty(total)
    _build.launch(lib, 'bin_faces', index, rect.data_ptr(), scan.data_ptr(),
                  mask.data_ptr(), bs, nf, is_, tile, total,
                  out['ids'].data_ptr(), out['order'].data_ptr(),
                  out['first'].data_ptr(), out['start'].data_ptr(),
                  entry='nr_bin_fill')
    tracing.COUNTS['work.faces'] += nseg
    tracing.COUNTS['work.bin_pairs'] += total
    tracing.COUNTS['work.bin_cells'] += cells
    return out


@functools.cache
def _bin_sizes(bs, nf, is_, tile):
    """(tile, chunk) cells and CUB scratch bytes of ``nr_bin_count``."""
    lib = _build.library('bin_faces')
    cells = lib.nr_bin_cells(bs, nf, is_, tile)
    temp_bytes = lib.nr_bin_scan_bytes(bs, nf, is_, tile)
    if cells < 0 or temp_bytes < 0:
        raise RuntimeError(f'bin_faces: no scan for {bs} x {nf} faces at '
                           f'{is_}^2 in {tile}-pixel tiles (more faces and '
                           '(tile, chunk) cells than int32 offsets hold, or '
                           'CUB failed)')
    return cells, temp_bytes


def bin_setup_plain(settings, faces, tile, records=('rec',)):
    """The plain PyTorch version of ``bin_setup``: ``bin_faces`` and the
    record functions, on any device."""
    start, ids, order, first = bin_faces(settings, faces, tile)
    out = dict(tile=tile, start=start, ids=ids, order=order, first=first)
    if 'rec' in records:
        out['rec'] = _face_records(settings, faces)
    if 'irec' in records:
        out['irec'] = _index_records(settings, faces)
    return out


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
    given; zeros where uncovered.  On the card also ``bins``, the kernel's
    tile lists (``bin_faces``: dict(tile, start, ids, order, first)), which
    ``backward_cuda.face_reduce`` reduces by.

    A CUDA tensor runs the kernel, which shades ``2 <= ts <= 4`` (a larger
    cube is shaded by ``texture.sample_textures`` after this call, as in the
    JAX package); a CPU tensor runs ``forward_shaded_plain``.
    """
    _check(settings, faces, textures)
    if not on_card(faces):
        with tracing.span('raster.shade'):
            return forward_shaded_plain(settings, faces, textures)
    ts = 0 if textures is None else textures.shape[2]
    if textures is not None and not 2 <= ts <= MAX_FUSED_TS:
        raise ValueError(f'the kernel shades 2 <= ts <= {MAX_FUSED_TS}; '
                         f'got ts={ts}')

    bs, is_ = faces.shape[0], settings.image_size
    texc = None if textures is None else textures.contiguous()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=faces.device)

    out = dict(face_index_map=empty(bs, is_, is_, dtype=torch.int32),
               depth_map=empty(bs, is_, is_), weights=empty(bs, 3, is_, is_),
               xy=empty(bs, 6, is_, is_), z=empty(bs, 3, is_, is_))
    if textures is not None:
        out['rgb'] = empty(bs, 3, is_, is_)
    out['bins'] = _launch_binned(
        'forward_shaded', 'raster.shade', 'rec', settings, faces,
        [_build.ptr(texc)],
        [ts, settings.near, settings.far, ts - 1 - settings.eps],
        [out['face_index_map'], out['depth_map'], out['weights'], out['xy'],
         out['z'], out.get('rgb')])
    return out


def _launch_binned(name, stage, record, settings, faces, inputs, scalars,
                   outputs):
    """Launch kernel ``name`` (of library ``name``) on the binned tiles of
    ``faces``: ``nr_<name>(records, start, ids, *inputs, bs, nf, is,
    *scalars, *outputs, stream)``, with the per-face records
    (``record``: 'rec' or 'irec') and the CSR tile lists made on the card by
    ``bin_setup`` at the kernel's tile size; the launch is the span
    ``stage``.  Returns the tile lists: dict(tile, start, ids, order,
    first) of ``bin_faces``."""
    lib = _build.library(name)
    bs, nf = faces.shape[:2]
    bins = bin_setup(settings, faces, getattr(lib, f'nr_{name}_tile')(),
                     records=(record,))
    rec = bins.pop(record)
    with tracing.span(stage):
        _build.launch(lib, name, faces.get_device(), rec.data_ptr(),
                      bins['start'].data_ptr(), bins['ids'].data_ptr(),
                      *inputs, bs, nf, settings.image_size, *scalars,
                      *map(_build.ptr, outputs))
    return bins


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


def forward_face_index_map(settings, faces):
    """NDC ``faces [bs, nf, 3, 3]`` -> (face_index_map int32 ``[bs, is, is]``,
    -1 uncovered; depth f32 ``[bs, is, is]``, the raw minimum
    ``wsum / sum_k w_k (1/z_k)`` of the z test, ``far`` uncovered).

    A CUDA tensor runs ``csrc/forward_index.cu`` (any face count, one
    launch); a CPU tensor runs ``forward_face_index_map_plain``.
    """
    _check(settings, faces, None)
    if not on_card(faces):
        return forward_face_index_map_plain(settings, faces)
    shape = (faces.shape[0], settings.image_size, settings.image_size)
    idx = torch.empty(shape, dtype=torch.int32, device=faces.device)
    depth = torch.empty(shape, dtype=torch.float32, device=faces.device)
    _launch_binned('forward_index', 'raster.index', 'irec', settings, faces,
                   [], [settings.near, settings.far], [idx, depth])
    return idx, depth


# the plain version of forward_face_index_map: the dense oracle returns
# exactly these two maps
forward_face_index_map_plain = forward_dense.forward_face_index_map


# ---- the JAX package's scene counters (forward_pallas.py) ----

def slice_size():
    """Faces per pass of the JAX package's Pallas forward: its 19-feature
    face table, padded to 128 lanes, fills an 8 MB VMEM budget at 16,384
    faces (forward_pallas.py:111-119); larger meshes run there as several
    passes.  The port's kernels take any face count in one launch."""
    return 16384


def _patch_dim(settings):
    return min(32, settings.image_size)


def patch_counts(settings, faces):
    """Front faces binned to each square patch, ``[bs, t, t]`` int64 with
    ``t = is // min(32, is)``: the counts of the JAX package's
    ``_membership_prefix`` (forward_pallas.py:211-262), same conservative
    bbox (``+-1`` pad), same clipping, and a NaN tile index cast to 0 as
    XLA casts it.  Each face's patch rectangle is added to a 2-D difference
    array and summed up, so no ``[bs, patches, nf]`` mask is built."""
    bs, nf = faces.shape[:2]
    is_ = settings.image_size
    p = _patch_dim(settings)
    t = is_ // p
    front = geometry.is_frontface(faces)
    px = geometry.to_pixel_coords(faces[..., 0], is_)
    py = geometry.to_pixel_coords(faces[..., 1], is_)

    def rng(lo, hi):
        def tile(v):
            v = torch.clamp(torch.floor(v / p), 0, t - 1)
            return torch.nan_to_num(v, nan=0.0).long()
        t0, t1 = tile(lo), tile(hi)
        empty = (hi < 0) | (lo > is_ - 1)
        return t0, torch.where(empty, t0 - 1, t1)

    ty0, ty1 = rng(torch.floor(py.amin(-1)) - 1.0,
                   torch.ceil(py.amax(-1)) + 1.0)
    tx0, tx1 = rng(torch.floor(px.amin(-1)) - 1.0,
                   torch.ceil(px.amax(-1)) + 1.0)
    live = front & (ty1 >= ty0) & (tx1 >= tx0)
    b = torch.arange(bs, device=faces.device)[:, None].expand(bs, nf)
    diff = torch.zeros(bs * (t + 1) * (t + 1), dtype=torch.int64,
                       device=faces.device)
    for y, x, sign in ((ty0, tx0, 1), (ty0, tx1 + 1, -1),
                       (ty1 + 1, tx0, -1), (ty1 + 1, tx1 + 1, 1)):
        at = ((b * (t + 1) + y) * (t + 1) + x)[live]
        diff.index_add_(0, at, torch.full_like(at, sign))
    counts = diff.reshape(bs, t + 1, t + 1).cumsum(1).cumsum(2)
    return counts[:, :t, :t]


def _slices(faces):
    s = slice_size()
    return [faces[:, lo:lo + s] for lo in range(0, faces.shape[1], s)]


def chunk_capacity(settings, nf, faces_per_tile_cap=None):
    """The JAX package's per-patch face capacity for ``nf`` faces (the auto
    density heuristic, or ``faces_per_tile_cap``), in whole 128-face chunks
    (forward_pallas.py:458-467)."""
    nt = (settings.image_size // _patch_dim(settings)) ** 2
    if faces_per_tile_cap is None:
        cap = min(nf, max(512, (nf * 16) // nt))
    else:
        cap = min(faces_per_tile_cap, nf)
    return -(-cap // _CHUNK) * _CHUNK


def binning_overflow(settings, faces):
    """Most front faces binned to one patch, the max over 16,384-face
    slices (forward_pallas.py:1120-1132): what ``faces_per_tile_cap`` must
    cover in the JAX package."""
    return max([int(patch_counts(settings, sl).max()) for sl in
                _slices(faces)], default=0)


def _chunks_per_patch(settings, sl, faces_per_tile_cap):
    cap = chunk_capacity(settings, sl.shape[1], faces_per_tile_cap)
    counts = patch_counts(settings, sl).clamp(max=cap)
    return (counts + _CHUNK - 1) // _CHUNK


def chunks_needed(settings, faces, faces_per_tile_cap=None):
    """(patch, chunk) list entries of the JAX package's compact forward
    grid, the max over slices (forward_pallas.py:536-550): what
    ``forward_chunk_budget`` must cover."""
    return max([int(_chunks_per_patch(settings, sl, faces_per_tile_cap)
                    .clamp(min=1).sum()) for sl in _slices(faces)], default=0)


def csr_rows_needed(settings, faces, faces_per_tile_cap=None):
    """CSR rows, dump chunk included, of the JAX package's per-patch face
    reduction (forward_pallas.py:1106-1117): what ``grad_csr_rows`` must
    cover.  Defined for single-pass meshes (nf <= 16,384) only."""
    if faces.shape[1] > slice_size():
        raise ValueError(
            f'CSR reduction requires nf <= {slice_size()} (single-pass '
            'forward); multi-pass meshes reduce via the global segment_sum')
    chunks = _chunks_per_patch(settings, faces, faces_per_tile_cap)
    return (int(chunks.sum()) + 1) * _CHUNK
