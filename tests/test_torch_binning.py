"""The port's per-face setup and tile binning (plain versions) against the
JAX package, on the CPU.

``forward_cuda.bin_setup`` runs ``csrc/bin_faces.cu`` on the card and its
plain version, ``bin_setup_plain`` (``_face_records``, ``_index_records``,
``bin_faces``), on a CPU tensor; ``chip_smoke.py`` holds the kernels to the
plain versions on the card.  Here the plain versions are held against the
XLA code the JAX package bins with, run eagerly:

  * ``_face_records`` equals ``forward_pallas._feature_table(...)[:, :nf,
    :18]`` bit for bit;
  * at 32-pixel tiles, each tile's ``bin_faces`` list equals the ascending
    members (``pz > 0``) of its patch in ``forward_pallas.
    _membership_prefix``, on finite scenes (a NaN face: see
    ``test_nan_face_is_binned_by_jax_only``);
  * ``start``, ``ids``, ``order`` and ``first`` equal a brute-force numpy
    binning, and ``order`` names each pair's face and tile;
  * ``_index_records`` holds exactly the values of ``_face_records`` and
    ``geometry``.

Scenes: random 64^2 (bs 2, nf 40), the same with coincident duplicated and
with degenerate faces, and the teapot batch of tests/utils.py (three
all-zero meshes) at 64^2 and 128^2.  Tolerance: bit-equal records, equal
lists.

The design of ``csrc/bin_faces.cu`` through its plain versions
(``coverage_masks``: per-face pair counts, each 128-face chunk's tile box
and a 128-bit coverage mask per (tile, chunk); ``lists_from_masks``: the
scan and the O(1) ranks) gives ``bin_faces``' lists exactly, its masks hold
every chunk's faces of each tile and no bit outside the chunk's box, and
bits outside the box are never read: on the main path's teapot batch (bs
32 at 512^2), the ShapeNet model's 24 views at 512^2 (a face over 252
tiles, lists of 944), a NaN face, and nf 1, 31, 129 and 4928 (chunk
edges).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import forward_cuda, geometry
from neural_renderer_torch.rasterize.config import RasterizeSettings as TSet
from neural_renderer_tpu.rasterize import forward_pallas
from neural_renderer_tpu.rasterize.config import RasterizeSettings as JSet

torch.set_num_threads(2)


def _random(seed=11):
    rng = np.random.RandomState(seed)
    fc = rng.uniform(-0.9, 0.9, (2, 40, 3, 3)).astype(np.float32)
    fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
    return fc


def _teapot(size):
    """NDC faces of the teapot test batch (fill_back; rows 0, 1, 3 are
    all-zero meshes, so their faces are degenerate)."""
    vertices, faces, textures = utils.load_teapot_batch()
    r = nt.Renderer()
    r.eye = [1.0, 1.0, -2.7]
    r.image_size = size
    fc, _ = r._lit_faces(*nt.arrays_from_numpy(vertices, faces, textures,
                                                device='cpu'))
    return fc.numpy()


def _scene(name, size):
    if name == 'teapot':
        return _teapot(size)
    fc = _random()
    if name == 'duplicated':
        fc[:, 20:] = fc[:, :20]
    elif name == 'degenerate':
        fc[:, [3, 11, 17]] = 0.0
        fc[:, [25, 31], 1] = fc[:, [25, 31], 0]
    return fc


SCENES = [('random', 64), ('duplicated', 64), ('degenerate', 64),
          ('teapot', 64), ('teapot', 128)]


def _bits(a):
    a = np.ascontiguousarray(a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize('name,size', SCENES)
def test_face_records_match_feature_table(name, size):
    fc = _scene(name, size)
    nf = fc.shape[1]
    got = forward_cuda._face_records(TSet(image_size=size),
                                     torch.as_tensor(fc)).numpy()
    want = np.asarray(forward_pallas._feature_table(
        JSet(image_size=size, runtime_checks=False), jnp.asarray(fc)))
    assert got.shape == (fc.shape[0], nf, 18)
    np.testing.assert_array_equal(_bits(got), _bits(want[:, :nf, :18]))


@pytest.mark.parametrize('name,size', SCENES)
def test_lists_match_membership_prefix(name, size):
    fc = _scene(name, size)
    bs, nf = fc.shape[:2]
    start, ids, _, _ = (t.numpy() for t in forward_cuda.bin_faces(
        TSet(image_size=size), torch.as_tensor(fc), 32))
    pz, counts = forward_pallas._membership_prefix(
        JSet(image_size=size, runtime_checks=False), jnp.asarray(fc))
    pz = np.asarray(pz)[:, :, :, 0, :nf]
    t = size // 32
    assert start.shape == (bs * t * t + 1,)
    np.testing.assert_array_equal(np.diff(start), np.asarray(counts))
    for b in range(bs):
        for ty in range(t):
            for tx in range(t):
                k = (b * t + ty) * t + tx
                np.testing.assert_array_equal(
                    ids[start[k]:start[k + 1]],
                    np.flatnonzero(pz[b, ty, tx] > 0), err_msg=str((b, k)))
    assert start[-1] > 0


def test_nan_face_is_binned_by_jax_only():
    """A face with a NaN x: the port bins it nowhere (its x bbox compares
    false, t1 = t0 - 1), while the JAX package's int32 cast turns the NaN
    tile index into 0, so the patches of column 0 in the face's y range
    list it (front: NaN < NaN is false).  Neither z test lets the face win
    a pixel; ROADMAP Queue 3 pins the difference."""
    fc = _scene('random', 64)
    fc[0, 5, 1, 0] = np.nan
    start, ids, _, first = (t.numpy() for t in forward_cuda.bin_faces(
        TSet(image_size=64), torch.as_tensor(fc), 32))
    pz, _ = forward_pallas._membership_prefix(
        JSet(image_size=64, runtime_checks=False), jnp.asarray(fc))
    pz = np.asarray(pz)[0, :, :, 0, 5]
    assert 5 not in ids[start[0]:start[4]]
    assert first[6] == first[5]
    assert (pz[:, 0] > 0).any() and (pz[:, 1] == 0).all()


def _brute_force(fc, size, tile):
    """(start, ids, order, first) from a numpy float32 bbox per face and a
    Python walk over each face's tiles."""
    bs, nf = fc.shape[:2]
    nt_ = -(-size // tile)
    x, y = fc[..., 0], fc[..., 1]
    front = ~((y[..., 2] - y[..., 0]) * (x[..., 1] - x[..., 0])
              < (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    p = [0.5 * (c * size + size - 1.0) for c in (x, y)]

    def tiles(c):
        lo = np.floor(c.min(-1)) - 1.0
        hi = np.ceil(c.max(-1)) + 1.0
        t0 = np.clip(np.floor(lo / tile), 0, nt_ - 1).astype(int)
        t1 = np.clip(np.floor(hi / tile), 0, nt_ - 1).astype(int)
        hit = (hi >= 0) & (lo <= size - 1)
        return np.where(hit, t0, 0), np.where(hit, t1, -1)

    (tx0, tx1), (ty0, ty1) = tiles(p[0]), tiles(p[1])
    pairs = []                    # face-major: (tile key, face id)
    first = [0]
    for b in range(bs):
        for f in range(nf):
            if front[b, f]:
                for ty in range(ty0[b, f], ty1[b, f] + 1):
                    for tx in range(tx0[b, f], tx1[b, f] + 1):
                        pairs.append(((b * nt_ + ty) * nt_ + tx, f))
            first.append(len(pairs))
    keys = np.array([k for k, _ in pairs], np.int64)
    order = np.argsort(keys, kind='stable')
    ids = np.array([pairs[i][1] for i in order], np.int64)
    start = np.searchsorted(keys[order], np.arange(bs * nt_ * nt_ + 1))
    return start, ids, order, np.array(first), keys


@pytest.mark.parametrize('name,size,tile', [
    ('random', 64, 16), ('duplicated', 64, 8), ('degenerate', 64, 16),
    ('teapot', 64, 16), ('teapot', 100, 16), ('teapot', 128, 32)])
def test_order_and_first_match_brute_force(name, size, tile):
    fc = _scene(name, size)
    nf = fc.shape[1]
    got = [t.numpy() for t in forward_cuda.bin_faces(
        TSet(image_size=size), torch.as_tensor(fc), tile)]
    start, ids, order, first, keys = _brute_force(fc, size, tile)
    for g, w, what in zip(got, (start, ids, order, first),
                          ('start', 'ids', 'order', 'first')):
        assert g.dtype == np.int32, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    # tile-major pair i is face-major row order[i]: that row belongs to face
    # ids[i] (first[s] <= row < first[s + 1]) and to the pair's tile
    gstart, gids, gorder, gfirst = got
    seg = np.searchsorted(gfirst, gorder, side='right') - 1
    np.testing.assert_array_equal(seg % nf, gids)
    tile_of_pair = np.repeat(np.arange(len(gstart) - 1), np.diff(gstart))
    np.testing.assert_array_equal(keys[gorder], tile_of_pair)
    assert len(gids) > 0


@pytest.mark.parametrize('name,size', [('degenerate', 64), ('teapot', 128)])
def test_index_records_hold_face_records_and_geometry(name, size):
    fc = torch.as_tensor(_scene(name, size))
    s = TSet(image_size=size)
    irec = forward_cuda._index_records(s, fc).numpy()
    rec = forward_cuda._face_records(s, fc).numpy()
    f = fc.numpy()
    x, y, z = f[..., 0], f[..., 1], f[..., 2]
    px = geometry.to_pixel_coords(fc[..., 0], size)
    py = geometry.to_pixel_coords(fc[..., 1], size)
    with np.errstate(divide='ignore'):          # all-zero faces: 1/0
        iz = np.float32(1.0) / z
    assert irec.shape == fc.shape[:2] + (28,) and irec.dtype == np.float32
    want = {
        slice(0, 6): rec[..., :6],
        slice(6, 12): np.stack([x[..., 1] - x[..., 0], y[..., 1] - y[..., 0],
                                x[..., 2] - x[..., 1], y[..., 2] - y[..., 1],
                                x[..., 0] - x[..., 2], y[..., 0] - y[..., 2]],
                               -1),
        slice(12, 21): rec[..., 9:18],
        slice(21, 24): iz,
        slice(24, 25): (torch.floor(py.amin(-1)) - 1.0).numpy()[..., None],
        slice(25, 26): (torch.ceil(py.amax(-1)) + 1.0).numpy()[..., None],
        slice(26, 27): (torch.floor(px.amin(-1)) - 1.0).numpy()[..., None],
        slice(27, 28): (torch.ceil(px.amax(-1)) + 1.0).numpy()[..., None],
    }
    for cols, w in want.items():
        np.testing.assert_array_equal(_bits(irec[..., cols]), _bits(w),
                                      err_msg=str(cols))


def test_bin_setup_on_cpu_runs_plain_and_launches_nothing():
    fc = torch.as_tensor(_scene('teapot', 64))
    s = TSet(image_size=64)
    before = tracing.counts()
    got = forward_cuda.bin_setup(s, fc, 16, records=('rec', 'irec'))
    assert tracing.counts() == before
    assert set(got) == {'tile', 'start', 'ids', 'order', 'first', 'rec',
                        'irec'}
    assert got['tile'] == 16
    for t, w in zip((got['start'], got['ids'], got['order'], got['first']),
                    forward_cuda.bin_faces(s, fc, 16)):
        assert torch.equal(t, w)
    assert torch.equal(got['rec'], forward_cuda._face_records(s, fc))
    assert torch.equal(got['irec'], forward_cuda._index_records(s, fc))
    assert 'irec' not in forward_cuda.bin_setup(s, fc, 16)
    with pytest.raises(ValueError, match='unknown records'):
        forward_cuda.bin_setup(s, fc, 16, records=('zbuf',))


def _views(vertices, faces, eyes, size):
    """NDC faces (fill_back) of a mesh seen from each of ``eyes``."""
    r = nt.Renderer()
    r.image_size = size
    r.eye = np.asarray(eyes, np.float32)
    n = len(eyes)
    tex = np.ones((faces.shape[0], 1, 1, 1, 3), np.float32)
    v, f, t = nt.arrays_from_numpy(vertices, faces, tex, device='cpu')
    fc, _ = r._lit_faces(v[None].expand(n, -1, -1), f[None].expand(n, -1, -1),
                         t[None].expand((n,) + t.shape))
    return fc


def _mask_scene(name):
    """(NDC faces, raster size) of a scene for the coverage masks."""
    if name in ('teapot bs 32', 'nf 4928'):
        vertices, faces = nt.load_obj(os.path.join(utils.DATA_DIR,
                                                   'teapot.obj'))
        if name == 'nf 4928':
            return _views(vertices, faces, [[1.0, 1.0, -2.7]], 256), 256
        eyes = [nt.get_points_from_angles(2.732, 30.0, float(a))
                for a in range(0, 360, 45) for _ in range(4)]
        return _views(vertices, faces, eyes, 512), 512
    if name == 'model 24 views':
        vertices, faces = nt.load_obj(os.path.join(
            utils.DATA_DIR, '4e49873292196f02574b5684eaec43e9', 'model.obj'))
        az = np.linspace(0, 360, 24, endpoint=False).astype(np.float32)
        eyes = nt.get_points_from_angles(
            torch.full((24,), 2.732), torch.full((24,), 30.0),
            torch.as_tensor(az))
        return _views(vertices, faces, eyes, 512), 512
    nf = 40 if name == 'nan face' else int(name.split()[1])
    rng = np.random.RandomState(nf)
    fc = rng.uniform(-0.9, 0.9, (2, nf, 3, 3)).astype(np.float32)
    fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
    if name == 'nan face':
        fc[0, 5, 1, 0] = np.nan
        fc[1, 0, 2, 1] = np.nan
    return torch.as_tensor(fc), 64


@pytest.mark.parametrize('scene', ['teapot bs 32', 'model 24 views',
                                   'nan face', 'nf 1', 'nf 31', 'nf 129',
                                   'nf 4928'])
def test_coverage_masks_give_bin_faces(scene):
    fc, size = _mask_scene(scene)
    bs, nf = fc.shape[:2]
    s = TSet(image_size=size)
    tile = 16
    nt_ = -(-size // tile)
    nch = -(-nf // forward_cuda.BIN_CHUNK)
    count, box, mask = forward_cuda.coverage_masks(s, fc, tile)
    want = forward_cuda.bin_faces(s, fc, tile)
    assert count.shape == (bs, nf) and box.shape == (bs, nch, 4)
    assert mask.shape == (bs, nt_ * nt_, nch, 4)
    np.testing.assert_array_equal(count.reshape(-1).numpy(),
                                  np.diff(want[3].numpy()))
    # each (tile, chunk) cell's bits are its tile list's faces of the chunk
    start, ids = want[0].long(), want[1].long()
    tile_of = torch.repeat_interleave(torch.arange(bs * nt_ * nt_),
                                      start[1:] - start[:-1])
    cells = torch.bincount(tile_of * nch + ids // forward_cuda.BIN_CHUNK,
                           minlength=bs * nt_ * nt_ * nch)
    popc = forward_cuda._popcount(mask).sum(-1)
    assert torch.equal(popc.reshape(-1), cells)
    word = ((tile_of * nch + ids // forward_cuda.BIN_CHUNK) * 4
            + ids % forward_cuda.BIN_CHUNK // 32)
    assert bool(((mask.reshape(-1)[word] >> (ids % 32)) & 1).all())
    # no bit outside a chunk's box, and what lies there is never read
    t = torch.arange(nt_ * nt_)
    ty, tx = (t // nt_)[None, :, None], (t % nt_)[None, :, None]
    inside = ((ty >= box[:, None, :, 0]) & (ty <= box[:, None, :, 1])
              & (tx >= box[:, None, :, 2]) & (tx <= box[:, None, :, 3]))
    assert not bool((mask != 0).any(-1)[~inside].any())
    noise = torch.as_tensor(np.random.RandomState(1).randint(
        0, 2 ** 32, mask.shape, dtype=np.int64))
    noisy = torch.where(inside[..., None], mask, noise)
    for got in (forward_cuda.lists_from_masks(s, fc, tile, count, box, mask),
                forward_cuda.lists_from_masks(s, fc, tile, count, box,
                                              noisy)):
        for g, w, what in zip(got, want, ('start', 'ids', 'order', 'first')):
            assert g.dtype == torch.int32, what
            assert torch.equal(g, w), what
    lengths = start[1:] - start[:-1]
    if scene == 'model 24 views':
        assert int(lengths.max()) == 944 and int(count.max()) == 252
    if scene == 'nan face':
        assert int(count[0, 5]) == 0 and int(count[1, 0]) == 0
