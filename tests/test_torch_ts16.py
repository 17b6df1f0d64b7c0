"""The reference's textured-model cube, ts 16 (the benchmark's
``teapot_256aa_ts16`` configuration), on the CPU: the port's ``render`` and
its gradients to vertices and textures against the benchmark's plain
reference (``benchmark/reference``, plain PyTorch that imports nothing of
the port), and the card's route of the texture gradient
(``texture.grad_textures``: one launch of ``csrc/tex_scatter.cu``, which
sums each face's cube from the forward's tile lists) with its counters and
guards, the kernel played by ``_FakeTexScatter``.

Scene: the teapot (4,928 faces after fill_back) with a 16x16x16 cube a
face, bs 2 with an eye of its own per element, textures uniform in [0, 1)
and a vertex jitter N(0, 0.02), both seeded, 64^2 with anti-aliasing on (a
128^2 raster) and off.  Cubes above ts 4 are sampled in plain torch and
take the 8-corner scatter in the backward.  Each tolerance below gives its
reason.  The reference computed one precision below (the benchmark's
control, ``check.control``: camera, lighting and gather in bfloat16) fails
each of them by more than ten times.
"""

import ctypes
import pathlib
import sys

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import torch_fakes
from neural_renderer_torch import _build, tracing
from neural_renderer_torch.rasterize import core, forward_cuda
from neural_renderer_torch.rasterize import texture as tex
from neural_renderer_torch.rasterize.config import RasterizeSettings

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark import check, harness, scene  # noqa: E402
from benchmark.reference import renderer as ref  # noqa: E402

BENCH = harness.load_bench()
CELL = 'teapot.train_ts16_b32'
TS = 16
BS = 2
IMAGE_SIZE = 64
# rgb is a trilinear sample of lit cube values of order 1: the same
# float32 products as the reference's, in its order; a few ulps of 1
# (1.2e-7 each) at most, far below this
IMAGE_TOL = 1e-5
# each gradient's largest gap over the reference's largest magnitude: the
# same float32 terms, summed where the port's order may differ from the
# reference's (a face's pixels, a vertex's faces, a texture cell's corner
# rows): a few roundings of the sum
GRAD_TOL = 1e-5
TOLS = {'image_err': IMAGE_TOL, 'grad_vertices_err': GRAD_TOL,
        'grad_textures_err': GRAD_TOL}
# the card's texture gradient against the plain index_add_: the same
# float32 terms, each cell's summed in another order (a face's tile rows,
# then pixel order), held to this share of the column's max |value| (as
# chip_smoke.py holds the kernel)
SEGMENT_TOL = 1e-6
# the kernel's tile edge, the forward's
TILE = 16


def _config(anti_aliasing):
    _, cfg, traffic = harness.load_cell(BENCH, CELL)
    assert cfg['texture_size'] == TS and traffic['batch'] == 32
    cfg.update(image_size=IMAGE_SIZE, anti_aliasing=anti_aliasing)
    return cfg


def _scene(cfg, seed):
    v, f = scene.load_obj(scene.ROOT / cfg['mesh'])
    rng = np.random.default_rng(seed)
    v = v[None] + rng.normal(0.0, 0.02, (BS,) + v.shape).astype(np.float32)
    faces = torch.as_tensor(f)[None].repeat(BS, 1, 1)
    textures = torch.rand((BS, f.shape[0], TS, TS, TS, 3),
                          generator=torch.Generator().manual_seed(seed))
    eyes = torch.stack([scene.eye_at(cfg['distance'], cfg['elevation'], a)
                        for a in (70.0, 200.0)])
    return torch.as_tensor(v), faces, textures, eyes


def _renderer(cfg, eyes):
    r = nt.Renderer()
    for key in ('image_size', 'anti_aliasing', 'fill_back', 'viewing_angle',
                'near', 'far', 'rasterizer_eps', 'background_color'):
        setattr(r, key, cfg[key])
    r.eye = eyes
    return r


def _port(cfg, vertices, faces, textures, eyes):
    v = vertices.clone().requires_grad_(True)
    t = textures.clone().requires_grad_(True)
    image = _renderer(cfg, eyes).render(v, faces, t)
    gv, gt = torch.autograd.grad(image.sum(), [v, t])
    return image.detach(), {'vertices': gv, 'textures': gt}


def _port_lit(cfg, vertices, faces, textures, eyes):
    """``_port`` by the lit-cube route: the whole filled cube scaled by
    the light (``Renderer._lit_faces``), then ``rasterize`` without a
    light."""
    v = vertices.clone().requires_grad_(True)
    t = textures.clone().requires_grad_(True)
    r = _renderer(cfg, eyes)
    face_coords, lit = r._lit_faces(v, faces, t)
    image = nt.rasterize(face_coords, lit, r.image_size, r.anti_aliasing,
                         r.near, r.far, r.rasterizer_eps, r.background_color)
    gv, gt = torch.autograd.grad(image.sum(), [v, t])
    return image.detach(), {'vertices': gv, 'textures': gt}


@pytest.mark.parametrize('anti_aliasing', [True, False])
def test_render_and_grads_match_reference(anti_aliasing):
    cfg = _config(anti_aliasing)
    vertices, faces, textures, eyes = _scene(cfg, 2400 + anti_aliasing)
    got = _port(cfg, vertices, faces, textures, eyes)
    args = (cfg, 'render', ['vertices', 'textures'], vertices, faces,
            textures, eyes, 1)
    want = ref.run(*args)
    assert got[0].shape == want[0].shape == (BS, 3, IMAGE_SIZE, IMAGE_SIZE)
    # the teapot covers a good part of each image
    assert float((want[0].sum(1) > 0).float().mean()) > 0.1
    for k in ('vertices', 'textures'):
        assert got[1][k].shape == want[1][k].shape
        assert float(want[1][k].abs().max()) > 0
    gaps = check.compare(*got, *want)
    for k, tol in TOLS.items():
        assert gaps[k] <= tol, (k, gaps[k])
    # the reference one precision below fails each tolerance tenfold
    low = check.compare(*check.control(*args), *want)
    for k, tol in TOLS.items():
        assert low[k] > 10 * tol, (k, low[k])


class _FakeTexScatter:
    """Stands in for ``csrc/tex_scatter.cu``'s ``nr_tex_scatter`` on CPU
    tensors: reads the face-index map, the tile lists and the four maps
    behind the pointers and strides it is handed, gives each face-major row
    its tile (``tex_scatter_rows_kernel``, into the scratch it is handed),
    and sums each face's cube in the kernel's order: the face's rows, the
    pixels it won in tile order, then its 8 corners, each term in the
    kernel's float32 operations.  Every cell is written.  With a light
    (unlit cubes) each term's rgb gradient is scaled by the face's light,
    and the light's gradient sums each pixel's ``g * s`` in the same order,
    ``s`` its 8 corners' ``w * texel`` added in corner order."""

    launches = 0

    @staticmethod
    def nr_tex_scatter_tile():
        return TILE

    @staticmethod
    def _ints(address, n):
        return np.ctypeslib.as_array((ctypes.c_int * n).from_address(
            address)) if n else np.zeros(0, np.int32)

    @staticmethod
    def _floats(address, n):
        return np.ctypeslib.as_array((ctypes.c_float * n).from_address(
            address))

    @staticmethod
    def _strided(address, strides, shape):
        span = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
        buf = np.ctypeslib.as_array((ctypes.c_float * span).from_address(
            address))
        return np.lib.stride_tricks.as_strided(
            buf, shape, [4 * s for s in strides])

    @classmethod
    def nr_tex_scatter(cls, fim, start, order, first, row_tile, pairs, bs,
                       nf, is_, ts, maps, strides, hi, out, out_floats,
                       textures, light, grad_light, stream):
        cls.launches += 1
        assert out_floats == 3 * bs * nf * ts ** 3
        f32 = np.float32
        nt = -(-is_ // TILE)
        first = cls._ints(first, bs * nf + 1)
        assert pairs == int(first[-1])
        start = cls._ints(start, bs * nt * nt + 1)
        rows = cls._ints(row_tile, pairs)
        rows[cls._ints(order, pairs)] = np.repeat(np.arange(bs * nt * nt),
                                                  np.diff(start))
        face = cls._ints(fim, bs * is_ * is_).reshape(bs, is_, is_)
        shape4 = (bs, 3, is_, is_)
        z, w, d, g = (cls._strided(maps[i], strides[4 * i:4 * i + 4], s)
                      for i, s in enumerate((shape4, shape4,
                                             (bs, 1, is_, is_), shape4)))
        # each face-major row's face and tile pixels, in the kernel's order
        seg = np.repeat(np.arange(bs * nf), np.diff(first))[:, None]
        b = seg // nf
        t = rows[:, None] - b * nt * nt
        i = np.arange(TILE * TILE)
        y = (t // nt) * TILE + i // TILE
        x = (t % nt) * TILE + i % TILE
        inside = (y < is_) & (x < is_)
        won = inside & (face[b, np.minimum(y, is_ - 1),
                             np.minimum(x, is_ - 1)] == seg % nf)
        b, y, x, seg = (np.broadcast_to(a, won.shape)[won]
                        for a in (b, y, x, seg))
        depth = d[b, 0, y, x]
        with np.errstate(all='ignore'):
            tif = np.stack([(w[b, k, y, x] * f32(ts - 1))
                            * (depth / z[b, k, y, x]) for k in range(3)], 1)
            tif = np.minimum(np.maximum(tif, f32(0)), f32(hi))
            lo = np.clip(tif.astype(np.int32), 0, ts - 2)
        frac = tif - lo.astype(f32)
        grad = np.stack([g[b, c, y, x] for c in range(3)], 1)
        scaled = grad
        if light is not None:
            unlit = cls._floats(textures, out_floats).reshape(-1, 3)
            scaled = grad * cls._floats(light, bs * nf * 3).reshape(-1, 3)[
                seg]
            sample = np.zeros_like(grad)
        cells, terms = [], []
        for pn in range(8):
            bit = [(pn >> k) & 1 for k in range(3)]
            a = [frac[:, k] if bit[k] else f32(1) - frac[:, k]
                 for k in range(3)]
            ii = [lo[:, k] + bit[k] for k in range(3)]
            cells.append(seg * ts ** 3 + (ii[0] * ts + ii[1]) * ts + ii[2])
            w = (a[0] * a[1]) * a[2]
            terms.append(w[:, None] * scaled)
            if light is not None:
                sample = sample + w[:, None] * unlit[cells[-1]]
        if light is not None:
            gl = np.zeros((bs * nf, 3), f32)
            np.add.at(gl, seg, grad * sample)
            cls._floats(grad_light, bs * nf * 3)[:] = gl.reshape(-1)
        cube = np.zeros((bs * nf * ts ** 3, 3), f32)
        # pixel-major: each cell's terms added one after another in order
        np.add.at(cube, np.stack(cells, 1).reshape(-1),
                  np.stack(terms, 1).reshape(-1, 3))
        np.ctypeslib.as_array((ctypes.c_float * out_floats).from_address(
            out))[:] = cube.reshape(-1)
        return 0


def _bins(settings, faces):
    return dict(zip(('start', 'ids', 'order', 'first'),
                    forward_cuda.bin_faces(settings, faces, TILE)),
                tile=TILE)


@pytest.fixture
def scatter_on_card(monkeypatch):
    """``texture.grad_textures`` down its card route on CPU tensors, the
    kernel played by ``_FakeTexScatter`` and fed the forward's tile lists
    as the card's forward hands them over (``forward_shaded(...)['bins']``,
    here from ``bin_faces`` at the kernel's 16-pixel tiles)."""
    plain = forward_cuda.forward_shaded

    def with_bins(settings, faces, textures=None):
        out = plain(settings, faces, textures)
        out['bins'] = _bins(settings, faces)
        return out

    monkeypatch.setattr(forward_cuda, 'forward_shaded', with_bins)
    torch_fakes.fake_card(monkeypatch, tex, _FakeTexScatter)
    _FakeTexScatter.launches = 0
    tracing.reset()
    yield
    tracing.reset()


def _within_segment_tol(got, want):
    got, want = got.reshape(-1, 3), want.reshape(-1, 3)
    scale = want.abs().amax(0)
    assert float(scale.min()) > 0
    err = (got - want).abs().amax(0)
    assert bool((err <= SEGMENT_TOL * scale).all()), (err, scale)


def test_card_route_counts_and_equals_the_plain_scatter(scatter_on_card,
                                                        monkeypatch):
    """A training step at ts 16 launches the texture scatter once, writing
    ``bs * nf' * ts^3`` cells, and hands no rows to a sort; its texture
    gradient is the plain scatter's within ``SEGMENT_TOL`` (the same terms
    summed in the kernel's order), its vertex gradient and image the plain
    route's bit for bit.  The cubes come lit (``_port_lit``), so the
    scatter applies no light and gives no light's gradient."""
    cfg = _config(True)
    vertices, faces, textures, eyes = _scene(cfg, 2410)
    got = _port_lit(cfg, vertices, faces, textures, eyes)
    counts = tracing.counts()
    nfp = 2 * faces.shape[1]
    assert _FakeTexScatter.launches == 1
    assert counts['launch.tex_scatter'] == 1
    assert counts['k6.scatter'] == 1
    assert counts['work.k6_scatter_cells'] == BS * nfp * TS ** 3 \
        == 40_370_176
    assert 'work.k6_scatter_rows' not in counts
    assert 'light.folded' not in counts
    monkeypatch.setattr(tex, 'on_card', lambda t: False)
    tracing.reset()
    want = _port_lit(cfg, vertices, faces, textures, eyes)
    assert not any(k.startswith(('k6.', 'work.k6', 'launch.')) for k in
                   tracing.counts())
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]['vertices'], want[1]['vertices'])
    _within_segment_tol(got[1]['textures'], want[1]['textures'])


def test_card_route_with_the_light_folded_equals_the_plain_scatter(
        scatter_on_card, monkeypatch):
    """The ``Renderer``'s step at ts 16 hands the rasterizer unlit cubes
    and their light: one scatter launch gives the texture gradient and the
    light's, counted as the lit route's plus ``light.folded``.  Its image
    is the plain route's bit for bit, its texture gradient within
    ``SEGMENT_TOL`` of the column's max, and its vertex gradient within
    ``SEGMENT_TOL`` of its largest magnitude: the light's gradient, which
    reaches the vertices through the normals, is summed in the kernel's
    order on the card and in pixel order in the plain scatter."""
    cfg = _config(True)
    vertices, faces, textures, eyes = _scene(cfg, 2410)
    got = _port(cfg, vertices, faces, textures, eyes)
    counts = tracing.counts()
    nfp = 2 * faces.shape[1]
    assert _FakeTexScatter.launches == 1
    assert counts['light.folded'] == 1
    assert counts['launch.tex_scatter'] == 1
    assert counts['k6.scatter'] == 1
    assert counts['work.k6_scatter_cells'] == BS * nfp * TS ** 3
    monkeypatch.setattr(tex, 'on_card', lambda t: False)
    tracing.reset()
    want = _port(cfg, vertices, faces, textures, eyes)
    assert not any(k.startswith(('k6.', 'work.k6', 'launch.')) for k in
                   tracing.counts())
    assert torch.equal(got[0], want[0])
    gap = (got[1]['vertices'] - want[1]['vertices']).abs().max()
    assert float(gap) <= SEGMENT_TOL * float(want[1]['vertices'].abs().max())
    _within_segment_tol(got[1]['textures'], want[1]['textures'])


@pytest.mark.parametrize('step', ['ts4', 'silhouettes', 'no_grad'])
def test_card_route_counts_nothing_off_the_scatter(scatter_on_card, step):
    """A ts-4 step builds its texture gradient in the reduction, a
    silhouette step has no texture gradient and a render under no_grad no
    backward: none launches or counts the scatter."""
    cfg = _config(False)
    vertices, faces, textures, eyes = _scene(cfg, 2420)
    r = _renderer(cfg, eyes)
    v = vertices.clone().requires_grad_(step != 'no_grad')
    if step == 'silhouettes':
        torch.autograd.grad(r.render_silhouettes(v, faces).sum(), [v])
    elif step == 'ts4':
        t = textures[:, :, :4, :4, :4].clone().requires_grad_(True)
        torch.autograd.grad(r.render(v, faces, t).sum(), [v, t])
    else:
        with torch.no_grad():
            r.render(v, faces, textures)
    counts = tracing.counts()
    for key in ('launch.tex_scatter', 'k6.scatter', 'work.k6_scatter_rows',
                'work.k6_scatter_cells'):
        assert counts.get(key, 0) == 0, (key, counts)
    assert _FakeTexScatter.launches == 0


def _scatter_inputs(ts, seed):
    """The rasterizer's maps of the cell's scene at 64^2 (no AA), lit
    ``ts`` cubes, a random rgb gradient and the forward's tile lists."""
    cfg = _config(False)
    vertices, faces, _, eyes = _scene(cfg, seed)
    textures = torch.rand((BS, faces.shape[1], ts, ts, ts, 3),
                          generator=torch.Generator().manual_seed(seed))
    r = _renderer(cfg, eyes)
    s = RasterizeSettings(image_size=IMAGE_SIZE, near=float(cfg['near']),
                          far=float(cfg['far']),
                          eps=float(cfg['rasterizer_eps']),
                          return_alpha=False, return_depth=False)
    with torch.no_grad():
        fc, tx = r._lit_faces(vertices, faces, textures)
        _, _, _, maps = core._forward_all(s, fc, tx, torch.zeros(3))
    g_rgb = torch.randn((BS, IMAGE_SIZE, IMAGE_SIZE, 3),
                        generator=torch.Generator().manual_seed(seed + 1))
    args = (s, maps['face_index_map'], maps['z'].permute(0, 2, 3, 1),
            maps['weights'].permute(0, 2, 3, 1), maps['depth_map'], g_rgb,
            tuple(tx.shape))
    return args, _bins(s, fc)


@pytest.mark.parametrize('ts', [5, 8])
def test_card_route_sums_every_face_within_tolerance(scatter_on_card,
                                                     monkeypatch, ts):
    """The kernel's route on the rasterizer's maps as the backward hands
    them over (z and weights NHWC views of channel-leading maps), at two
    cubes above ts 4: within ``SEGMENT_TOL`` of the plain ``index_add_``,
    and exact zeros in the cubes of faces that won no pixel (the
    back-facing half after fill_back among them)."""
    args, bins = _scatter_inputs(ts, 2430 + ts)
    got = tex.grad_textures(*args, bins)
    monkeypatch.setattr(tex, 'on_card', lambda t: False)
    want = tex.grad_textures(*args)
    assert _FakeTexScatter.launches == 1
    assert got.shape == want.shape == args[-1]
    _within_segment_tol(got, want)
    won = torch.zeros(want.shape[:2], dtype=torch.bool)
    fim = args[1]
    for b in range(BS):
        won[b, fim[b][fim[b] >= 0].long()] = True
    assert bool((~won).any()) and bool(won.any())
    assert bool((got[~won] == 0).all())


def test_card_route_needs_bins(scatter_on_card):
    """On the card the scatter reads the forward's tile lists: none, or
    lists of another tile size, raise before any launch."""
    args, bins = _scatter_inputs(5, 2440)
    with pytest.raises(ValueError, match='needs bins'):
        tex.grad_textures(*args)
    with pytest.raises(ValueError, match='8-pixel tiles'):
        tex.grad_textures(*args, dict(bins, tile=8))
    assert _FakeTexScatter.launches == 0


class _RecordTexScatter:
    """Records ``nr_tex_scatter``'s arguments and writes nothing."""

    args = None

    @staticmethod
    def nr_tex_scatter_tile():
        return TILE

    @classmethod
    def nr_tex_scatter(cls, *args):
        cls.args = args
        return 0


def _meta_inputs(bs, nf, is_, ts, pairs=4):
    """Shapes only: the scatter's inputs as tensors on the meta device."""
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device='meta')
    nt = -(-is_ // TILE)
    bins = dict(start=t(bs * nt * nt + 1, dtype=torch.int32),
                ids=t(pairs, dtype=torch.int32),
                order=t(pairs, dtype=torch.int32),
                first=t(bs * nf + 1, dtype=torch.int32), tile=TILE)
    args = (RasterizeSettings(image_size=is_), t(bs, is_, is_,
                                                 dtype=torch.int32),
            t(bs, is_, is_, 3), t(bs, is_, is_, 3),
            t(bs, is_, is_), t(bs, is_, is_, 3), (bs, nf, ts, ts, ts, 3))
    return args, bins


@pytest.mark.parametrize('limit', ['faces', 'pixels', 'pairs'])
def test_card_route_refuses_int32_overflow(monkeypatch, limit):
    """Faces, raster pixels and (tile, face) pairs are int32 in the
    kernel: a call with 2^31 of any (the pairs' scratch holds one more
    word) raises before it allocates the cube or launches."""
    torch_fakes.fake_card(monkeypatch, tex, _RecordTexScatter)
    _RecordTexScatter.args = None
    shape = dict(faces=(1, 2 ** 31, 16, 6), pixels=(1, 8, 46_341, 6),
                 pairs=(1, 8, 32, 6, 2 ** 31 - 1))[limit]
    args, bins = _meta_inputs(*shape)
    with pytest.raises(ValueError, match='int32'):
        tex.grad_textures(*args, bins)
    assert _RecordTexScatter.args is None


def test_card_route_addresses_the_cube_with_64_bits(monkeypatch):
    """A cube past 2^31 floats (bs 1, 174,763 faces at ts 16: 2,147,487,744)
    goes to the kernel whole: its float count as a 64-bit argument, the
    shapes as given, the clamp limit ``ts - 1 - eps``, one launch and the
    counts; the kernel checks the count against the shape."""
    torch_fakes.fake_card(monkeypatch, tex, _RecordTexScatter)
    tracing.reset()
    nf, ts = 174_763, 16
    args, bins = _meta_inputs(1, nf, 32, ts)
    try:
        out = tex.grad_textures(*args, bins)
        counts = tracing.counts()
    finally:
        tracing.reset()
    floats = 3 * nf * ts ** 3
    assert floats == 2_147_487_744 > 2 ** 31
    assert out.shape == (1, nf, ts, ts, ts, 3)
    got = _RecordTexScatter.args
    types = _build.LIBRARIES['tex_scatter']['nr_tex_scatter'][1]
    assert len(got) == len(types)
    assert got[5:10] == (4, 1, nf, 32, ts)
    assert types[14] is _build.I64 and got[14] == floats
    assert np.isclose(got[12], ts - 1 - args[0].eps)
    assert counts == {'launch.tex_scatter': 1, 'k6.scatter': 1,
                      'work.k6_scatter_cells': nf * ts ** 3}
