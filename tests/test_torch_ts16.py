"""The reference's textured-model cube, ts 16 (the benchmark's
``teapot_256aa_ts16`` configuration), on the CPU: the port's ``render`` and
its gradients to vertices and textures against the benchmark's plain
reference (``benchmark/reference``, plain PyTorch that imports nothing of
the port), and the card's route of the texture gradient (the 8-corner
scatter sorted by cell and summed in order, ``texture.grad_textures``)
with its counters.

Scene: the teapot (4,928 faces after fill_back) with a 16x16x16 cube a
face, bs 2 with an eye of its own per element, textures uniform in [0, 1)
and a vertex jitter N(0, 0.02), both seeded, 64^2 with anti-aliasing on (a
128^2 raster) and off.  Cubes above ts 4 are sampled in plain torch and
take the 8-corner scatter in the backward.  Each tolerance below gives its
reason.  The reference computed one precision below (the benchmark's
control, ``check.control``: camera, lighting and gather in bfloat16) fails
each of them by more than ten times.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import torch_fakes
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import texture as tex

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


@pytest.fixture
def scatter_on_card(monkeypatch):
    """``texture.grad_textures`` down its card route on CPU tensors: the
    corner rows sorted by cell (``segments.sort_segments``) and summed in
    that order (``segments.segment_sum``, here its plain version), with
    the counts the card's route keeps."""
    torch_fakes.fake_card(monkeypatch, tex, object())
    tracing.reset()
    yield
    tracing.reset()


def test_card_route_counts_and_equals_the_plain_scatter(scatter_on_card,
                                                        monkeypatch):
    """A training step at ts 16 takes the 8-corner scatter once: 8 corner
    rows a raster pixel (``8 * bs * is^2``) onto ``bs * nf' * ts^3`` cells;
    its texture gradient is the plain scatter's, bit for bit (each cell's
    rows in the same order), and its vertex gradient too."""
    cfg = _config(True)
    vertices, faces, textures, eyes = _scene(cfg, 2410)
    got = _port(cfg, vertices, faces, textures, eyes)
    counts = tracing.counts()
    raster = 2 * IMAGE_SIZE
    nfp = 2 * faces.shape[1]
    assert counts['k6.scatter'] == 1
    assert counts['work.k6_scatter_rows'] == 8 * BS * raster * raster \
        == 262_144
    assert counts['work.k6_scatter_cells'] == BS * nfp * TS ** 3 \
        == 40_370_176
    monkeypatch.setattr(tex, 'on_card', lambda t: False)
    tracing.reset()
    want = _port(cfg, vertices, faces, textures, eyes)
    assert not any(k.startswith(('k6.', 'work.k6')) for k in
                   tracing.counts())
    assert torch.equal(got[0], want[0])
    for k in ('vertices', 'textures'):
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize('step', ['ts4', 'silhouettes', 'no_grad'])
def test_card_route_counts_nothing_off_the_scatter(scatter_on_card, step):
    """A ts-4 step builds its texture gradient in the reduction, a
    silhouette step has no texture gradient and a render under no_grad no
    backward: none counts the scatter."""
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
    for key in ('k6.scatter', 'work.k6_scatter_rows',
                'work.k6_scatter_cells'):
        assert counts.get(key, 0) == 0, (key, counts)
