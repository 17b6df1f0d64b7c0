"""The plain reference against the program's plain PyTorch versions on the
CPU, and the reference's independence from the program.

    python -m pytest benchmark/tests -q
"""

import ast
import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import neural_renderer_torch as nt  # noqa: E402

from benchmark import scene  # noqa: E402
from benchmark.reference import raster  # noqa: E402
from benchmark.reference import renderer as ref  # noqa: E402

CPU = torch.device('cpu')
BANNED = {'jax', 'jaxlib', 'flax', 'neural_renderer_tpu',
          'neural_renderer_torch'}
CFG = dict(mesh='data/teapot.obj', image_size=32, anti_aliasing=True,
           texture_size=2, fill_back=True, viewing_angle=30, near=0.1,
           far=100.0, rasterizer_eps=1e-3, background_color=[0.0, 0.0, 0.0],
           distance=2.732, elevation=30.0)
ENTRIES = [('render', ['vertices', 'textures']),
           ('render_silhouettes', ['vertices']),
           ('render_rgbad', [])]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program_or_jax():
    files = sorted((REPO / 'benchmark' / 'reference').glob('*.py'))
    assert files
    found = {(f.name, m) for f in files for m in _imports(f)
             if m.split('.')[0] in BANNED}
    assert not found


def _program(entry, grads, v, f, t, eye, image_size, aa=True):
    r = nt.Renderer()
    r.image_size, r.anti_aliasing, r.eye = image_size, aa, eye
    leaves = {'vertices': v.clone().requires_grad_('vertices' in grads),
              'textures': t.clone().requires_grad_('textures' in grads)}
    args = [leaves['vertices'], f]
    if entry != 'render_silhouettes':
        args.append(leaves['textures'])
    with torch.set_grad_enabled(bool(grads)):
        out = getattr(r, entry)(*args)
    got = (torch.autograd.grad(out.sum(), [leaves[g] for g in grads])
           if grads else [])
    if isinstance(out, dict):
        out = {k: x.detach() for k, x in out.items()}
    else:
        out = out.detach()
    return out, dict(zip(grads, got))


def _assert_close(images, grads, want_images, want_grads):
    if isinstance(images, dict):
        for k in images:
            torch.testing.assert_close(images[k], want_images[k], rtol=0,
                                       atol=1e-6)
    else:
        torch.testing.assert_close(images, want_images, rtol=0, atol=1e-6)
    for k, g in grads.items():
        w = want_grads[k]
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize('entry,grads', ENTRIES,
                         ids=[e for e, _ in ENTRIES])
@pytest.mark.parametrize('azimuth', [0.0, 45.0, 200.0])
def test_teapot_matches_program(entry, grads, azimuth):
    """The teapot at bs 2, 32^2 with AA (a 64^2 raster)."""
    v, f, t = scene.make(CFG, 2, 2 ** 31 + 7, CPU)
    eye = scene.eye_at(2.732, 30.0, azimuth)
    want = ref.run(CFG, entry, grads, v, f, t, eye, 1)
    got = _program(entry, grads, v, f, t, eye, 32)
    _assert_close(*got, *want)


def _random_scene(seed, bs=2, nf=12, ts=3):
    g = torch.Generator().manual_seed(seed)
    v = torch.rand((bs, 3 * nf, 3), generator=g) * 1.6 - 0.8
    f = torch.arange(3 * nf).reshape(nf, 3)[None].repeat(bs, 1, 1)
    t = torch.rand((bs, nf, ts, ts, ts, 3), generator=g)
    return v, f, t


@pytest.mark.parametrize('seed', [1, 2, 3])
@pytest.mark.parametrize('aa', [True, False])
def test_small_scenes_match_program(seed, aa):
    """Random overlapping faces at 64^2, ts 3, with and without AA."""
    v, f, t = _random_scene(seed)
    cfg = dict(CFG, image_size=64, anti_aliasing=aa, texture_size=3)
    eye = scene.eye_at(2.732, 20.0, 30.0 * seed)
    for entry, grads in ENTRIES:
        want = ref.run(cfg, entry, grads, v, f, t, eye, 2)
        got = _program(entry, grads, v, f, t, eye, 64, aa)
        _assert_close(*got, *want)


@pytest.mark.parametrize('seed', [4, 5])
def test_raster_with_all_outputs_matches_program(seed):
    """rgb, alpha and depth drawn together with random output gradients:
    K5 with both value terms, K6 and K7 at once."""
    v, f, t = _random_scene(seed, nf=10, ts=2)
    faces = ref.raster_faces(dict(CFG, image_size=64), 'render', v, f,
                             scene.eye_at(2.732, 25.0, 15.0 * seed))
    t = torch.cat([t, t], dim=1)
    g = torch.Generator().manual_seed(seed)
    gouts = [torch.randn((2, 3, 64, 64), generator=g),
             torch.randn((2, 64, 64), generator=g),
             torch.randn((2, 64, 64), generator=g)]

    def grads(fn):
        fc = faces.clone().requires_grad_(True)
        tx = t.clone().requires_grad_(True)
        out = fn(fc, tx)
        loss = sum((out[k] * go).sum()
                   for k, go in zip(('rgb', 'alpha', 'depth'), gouts))
        return out, torch.autograd.grad(loss, [fc, tx])

    want_out, want = grads(lambda fc, tx: raster.rasterize(
        fc, tx, 64, False, 0.1, 100.0, 1e-3, [0.2, 0.3, 0.4],
        ('rgb', 'alpha', 'depth')))
    got_out, got = grads(lambda fc, tx: nt.rasterize_rgbad(
        fc, tx, 64, False, 0.1, 100.0, 1e-3, [0.2, 0.3, 0.4]))
    for k in want_out:
        torch.testing.assert_close(got_out[k].detach(),
                                   want_out[k].detach(), rtol=0, atol=1e-6)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_blocks_give_one_call():
    """The reference over the batch in blocks equals one call."""
    v, f, t = scene.make(CFG, 3, 11, CPU)
    eye = scene.eye_at(2.732, 30.0, 90.0)
    a = ref.run(CFG, 'render', ['vertices', 'textures'], v, f, t, eye, 1)
    b = ref.run(CFG, 'render', ['vertices', 'textures'], v, f, t, eye, 3)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    for k in a[1]:
        torch.testing.assert_close(a[1][k], b[1][k], rtol=0, atol=1e-7)


def test_scene_loads_as_the_program_does():
    """The benchmark's OBJ reader gives the program's load_obj arrays."""
    v, f = scene.load_obj(scene.ROOT / 'data' / 'teapot.obj')
    pv, pf = nt.load_obj(str(REPO / 'tests' / 'data' / 'teapot.obj'))
    assert v.shape == (1292, 3) and f.shape == (2464, 3)
    assert (v == pv).all() and (f == pf).all()
