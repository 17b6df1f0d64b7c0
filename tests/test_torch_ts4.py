"""The reference's default texture cube, ts 4 (the benchmark's
``teapot_256aa_ts4`` configuration), on the CPU: the port's ``render`` and
its gradients to vertices and textures against the benchmark's plain
reference (``benchmark/reference``, plain PyTorch that imports nothing of
the port), and the factor path's texture gradient against the 8-corner
scatter on the same maps.

Scene: the teapot (4,928 faces after fill_back) with a 4x4x4 cube a face,
bs 2 with an eye of its own per element, textures uniform in [0, 1) and a
vertex jitter N(0, 0.02), both seeded, 64^2 with anti-aliasing on (a 128^2
raster) and off.  Each tolerance below gives its reason.  The reference
computed one precision below (the benchmark's control, ``check.control``:
camera, lighting and gather in bfloat16) fails each of them by more than
ten times.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
from neural_renderer_torch.rasterize import backward_cuda, core
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize import texture as tex
from neural_renderer_torch.rasterize.config import RasterizeSettings

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmark import check, harness, scene  # noqa: E402
from benchmark.reference import renderer as ref  # noqa: E402

BENCH = harness.load_bench()
CELL = 'teapot.train_ts4_b128'
TS = 4
BS = 2
IMAGE_SIZE = 64
# rgb is a trilinear sample of lit cube values of order 1, the same
# float32 products summed in another order than the reference's: a few
# ulps of 1 (1.2e-7 each), far below this
IMAGE_TOL = 1e-5
# each gradient's largest gap over the reference's largest magnitude: the
# same float32 terms summed over a face's pixels (and a vertex's faces) in
# another order, a few roundings of the sum
GRAD_TOL = 1e-5
# the factor path against the 8-corner scatter: each cell's products
# (p01 * a2) * g against the scatter's corner weight times g, summed over
# the same pixels in another order
FACTOR_TOL = 1e-5


def _config(anti_aliasing):
    _, cfg, _ = harness.load_cell(BENCH, CELL)
    assert cfg['texture_size'] == TS
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
                        for a in (20.0, 245.0)])
    return torch.as_tensor(v), faces, textures, eyes


def _port(cfg, vertices, faces, textures, eyes):
    r = nt.Renderer()
    for key in ('image_size', 'anti_aliasing', 'fill_back', 'viewing_angle',
                'near', 'far', 'rasterizer_eps', 'background_color'):
        setattr(r, key, cfg[key])
    r.eye = eyes
    v = vertices.clone().requires_grad_(True)
    t = textures.clone().requires_grad_(True)
    image = r.render(v, faces, t)
    gv, gt = torch.autograd.grad(image.sum(), [v, t])
    return image.detach(), {'vertices': gv, 'textures': gt}


TOLS = {'image_err': IMAGE_TOL, 'grad_vertices_err': GRAD_TOL,
        'grad_textures_err': GRAD_TOL}


@pytest.mark.parametrize('anti_aliasing', [True, False])
def test_render_and_grads_match_reference(anti_aliasing):
    cfg = _config(anti_aliasing)
    vertices, faces, textures, eyes = _scene(cfg, 2200 + anti_aliasing)
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


@pytest.mark.parametrize('anti_aliasing', [True, False])
def test_factor_path_equals_the_corner_scatter(anti_aliasing):
    """The texture gradient at ts 4 through the reduction's K6 factors
    (``texture_cell_factors`` of the maps, expanded by
    ``face_reduce_plain``) against
    the 8-corner scatter that cubes above ts 4 take
    (``texture.grad_textures``), on the same forward maps and a random
    rgb gradient."""
    cfg = _config(anti_aliasing)
    vertices, faces, _, eyes = _scene(cfg, 2300 + anti_aliasing)
    fc = ref.raster_faces(cfg, 'render', vertices, faces, eyes)
    nf = fc.shape[1]
    is_ = ref.raster_size(cfg)
    settings = RasterizeSettings(image_size=is_, eps=cfg['rasterizer_eps'])
    tx = torch.rand((BS, nf, TS, TS, TS, 3),
                    generator=torch.Generator().manual_seed(7))
    maps = forward_cuda.forward_shaded(settings, fc, tx)
    fim = maps['face_index_map']
    assert int((fim >= 0).sum()) > 0.1 * BS * is_ * is_
    g_rgb = torch.randn((BS, is_, is_, 3),
                        generator=torch.Generator().manual_seed(8))
    stack = core.channel_stack(settings, maps, g_rgb, None, None, False,
                               False)
    assert stack.shape[1] == 0
    k6 = backward_cuda.K6Maps(settings, TS, maps['z'], maps['weights'],
                              maps['depth_map'], g_rgb)
    assert k6.factors(fim).shape[1] == TS * TS + TS + 3 == 23
    sums = backward_cuda.face_reduce_plain(stack, fim, nf, k6)
    assert sums.shape == (BS * nf, 3 * TS ** 3)
    got = sums.reshape(tx.shape)
    want = tex.grad_textures(settings, fim, maps['z'].permute(0, 2, 3, 1),
                             maps['weights'].permute(0, 2, 3, 1),
                             maps['depth_map'], g_rgb, tx.shape)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= FACTOR_TOL * scale
