"""The dense-mesh silhouette fit (the benchmark's ``icosphere163k``
configuration) on the CPU: the port's ``render_silhouettes`` and its vertex
gradient against the benchmark's plain reference (``benchmark/reference``,
plain PyTorch that imports nothing of the port), and the mesh file the
configuration reads.

Scenes: icospheres of subdivision 2 (320 faces) and 3 (1,280 faces, the
642-vertex template of the paper's reconstruction), each vertex moved by
seeded noise, bs 2 with an eye of its own per element, 64^2 with
anti-aliasing on (a 128^2 raster) and off.

* Alpha is held pixel for pixel.  Coverage does not depend on which of two
  tied faces wins, so only a pixel centre that lies on a face edge, where
  the two camera transforms' last bits decide the inside test, may differ:
  every pixel that differs is shown to have such a centre.
* The vertex gradient's largest gap over the reference's largest magnitude
  is held to ``GRAD_TOL``: both compute in float32 in another order of
  operations, so the gap may be a few float32 roundings of the camera and
  the sweeps' divisions, carried into a sum over the faces of each vertex
  (the plain versions read 0 here, alpha too).  The reference computed
  with its camera in bfloat16 (the benchmark's control) reads 1.4 to 5.0,
  and the test shows it above ten times the tolerance.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from benchmark import check, harness, scene  # noqa: E402
from benchmark.reference import renderer as ref  # noqa: E402

BENCH = harness.load_bench()
CELL = 'icosphere163k.sil_train_b128'
OBJ = REPO / 'benchmark' / 'data' / 'icosphere6.obj'
BS = 2
IMAGE_SIZE = 64
# the gradient's largest gap over the reference's largest magnitude (see
# the module docstring)
GRAD_TOL = 1e-4
# how near an edge, in NDC, a pixel centre whose coverage differs must lie:
# a few float32 ulps of coordinates of magnitude ~1
EDGE_TOL = 1e-5


def _config(anti_aliasing):
    _, cfg, _ = harness.load_cell(BENCH, CELL)
    cfg.update(image_size=IMAGE_SIZE, anti_aliasing=anti_aliasing)
    return cfg


def _scene(subdiv, seed):
    v, f = chip_smoke._icosphere(subdiv)
    rng = np.random.default_rng(seed)
    v = v + rng.normal(0.0, 0.02, (BS,) + v.shape).astype(np.float32)
    faces = torch.as_tensor(f.astype(np.int64))[None].repeat(BS, 1, 1)
    eyes = torch.stack([scene.eye_at(2.732, 30.0, a) for a in (20.0, 245.0)])
    return torch.as_tensor(v), faces, eyes


def _port(cfg, vertices, faces, eyes):
    r = nt.Renderer()
    for key in ('image_size', 'anti_aliasing', 'fill_back', 'viewing_angle',
                'near', 'far', 'background_color'):
        setattr(r, key, cfg[key])
    r.eye = eyes
    v = vertices.clone().requires_grad_(True)
    alpha = r.render_silhouettes(v, faces)
    grad, = torch.autograd.grad(alpha.sum(), v)
    return alpha.detach(), grad


def _off_edge(cfg, vertices, faces, eyes, b, row, col):
    """Whether no raster pixel centre under output pixel (``row``,
    ``col``) of element ``b`` lies within ``EDGE_TOL`` of an edge of a
    face the reference draws."""
    fc = ref.raster_faces(cfg, 'render_silhouettes', vertices[b:b + 1],
                          faces[b:b + 1], eyes[b:b + 1])[0].double()
    is_ = ref.raster_size(cfg)
    k = 2 if cfg['anti_aliasing'] else 1
    # the output is flipped vertically: output row r is raster row is-1-r
    centres = [((2.0 * x + 1.0 - is_) / is_, (2.0 * y + 1.0 - is_) / is_)
               for y in range(is_ - k * (row + 1), is_ - k * row)
               for x in range(k * col, k * (col + 1))]
    a, c = fc[:, :, :2], fc[:, [1, 2, 0], :2]
    d = c - a
    for cx, cy in centres:
        p = torch.tensor([cx, cy], dtype=torch.float64)
        t = (((p - a) * d).sum(-1) / (d * d).sum(-1)).clamp(0.0, 1.0)
        dist = (a + t[..., None] * d - p).norm(dim=-1)
        if float(dist.min()) <= EDGE_TOL:
            return False
    return True


@pytest.mark.parametrize('subdiv,anti_aliasing',
                         [(2, True), (2, False), (3, True), (3, False)])
def test_silhouettes_and_vertex_grads_match_reference(subdiv, anti_aliasing):
    cfg = _config(anti_aliasing)
    vertices, faces, eyes = _scene(subdiv, 1700 + subdiv)
    got_alpha, got_grad = _port(cfg, vertices, faces, eyes)
    # silhouettes read no textures; the control casts them all the same
    textures = torch.zeros((BS, faces.shape[1], 1, 1, 1, 3))
    args = (cfg, 'render_silhouettes', ['vertices'], vertices, faces,
            textures, eyes, 1)
    want_alpha, want = ref.run(*args)
    want_grad = want['vertices']
    assert got_alpha.shape == want_alpha.shape == (BS, IMAGE_SIZE,
                                                   IMAGE_SIZE)
    assert float(want_alpha.sum()) > 0.1 * BS * IMAGE_SIZE ** 2
    for b, row, col in torch.nonzero(got_alpha != want_alpha).tolist():
        assert not _off_edge(cfg, vertices, faces, eyes, b, row, col), (
            f'alpha differs at element {b}, pixel ({row}, {col}), whose '
            'centres lie on no face edge')
    scale = float(want_grad.abs().max())
    assert scale > 0
    gap = float((got_grad - want_grad).abs().max()) / scale
    assert gap <= GRAD_TOL
    # the reference with its camera in bfloat16 fails the same tolerance
    _, low = check.control(*args)
    low_gap = float((low['vertices'] - want_grad).abs().max()) / scale
    assert low_gap > 10 * GRAD_TOL


def test_icosphere6_obj_is_the_bench_mesh():
    v, f = chip_smoke._icosphere(6)
    rows = [line.split() for line in OBJ.read_text().splitlines()]
    fv = np.array([[float(x) for x in r[1:4]] for r in rows if r[:1] == ['v']],
                  np.float32)
    ff = np.array([[int(x) for x in r[1:4]] for r in rows if r[:1] == ['f']],
                  np.int64)
    assert fv.shape == (40962, 3) and ff.shape == (81920, 3)
    # written at %.9g, so each float32 reads back exactly; faces 1-based
    np.testing.assert_array_equal(fv, v)
    np.testing.assert_array_equal(ff - 1, f)
    # the benchmark reads it as the reference's load_obj does: normalised
    # into a cube of side 2, the sphere of radius 0.9 becomes the unit one
    nv, nf = scene.load_obj(OBJ)
    np.testing.assert_array_equal(nf, f)
    radius = np.linalg.norm(nv.astype(np.float64), axis=1)
    assert np.abs(radius - 1.0).max() <= 1e-6
