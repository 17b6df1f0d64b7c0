"""The per-face light folded into sampling and the texture scatter, on the
CPU: cubes above ts 4 reach the rasterizer unlit with their light
``[bs, nf', 3]`` (``Renderer._light``), K4 scales each texel it reads by
the winner's light and the 8-corner scatter scales each term and gives the
light's gradient (``texture.grad_textures``), so no lit cube is made.

Each case renders one scene twice: the ``Renderer``'s route (the light
folded) and the lit-cube route it replaced, built here from the public
ops (``vertices_to_faces``, fill_back of the cubes, ``lighting``, the
camera transform, then ``rasterize`` without a light).  The images are
bit-equal: ``texel * light`` is the very product the lit cube holds.  The
gradients hold the same terms summed in another order: the texture
gradient ``w * (g * light)`` against ``(sum of w * g) * light``, the
light's ``sum of g * (sum of w * texel)`` against the sum over the cube
of ``(sum of w * g) * texel``, so they are held to a few roundings of
their largest magnitudes.  ``light.folded`` counts the renders that fold
the light: 1 above ts 4, 0 at ts <= 4, for silhouettes and depth, and
for a ``rasterize`` call given lit cubes.
"""

import os

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.ops.lighting import face_light
from neural_renderer_torch.ops.vertices_to_faces import vertices_to_faces
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize.config import RasterizeSettings

TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')
BS = 2
IMAGE_SIZE = 32
# the texture gradient's largest gap per rgb column over that column's
# largest magnitude: the same float32 terms, each cell's the light times
# a sum against a sum of products with the light (test_torch_ts16.py's
# SEGMENT_TOL)
SEGMENT_TOL = 1e-6
# the vertex gradient's largest gap over its largest magnitude: the
# light's gradient summed over pixels against over texels, carried
# through the normals (test_torch_ts16.py's GRAD_TOL)
GRAD_TOL = 1e-5


def _teapot():
    v, f = nt.load_obj(TEAPOT)
    return np.asarray(v, np.float32), np.asarray(f, np.int64)


def _box():
    """An axis-aligned cube of edge 1: under the default light (0, 1, 0)
    its four sides are edge-on to it, cos exactly 0."""
    v = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                  for z in (-.5, .5)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    return v, f


# case -> (mesh, ts, fill_back, renderer attributes, jitter the vertices)
CASES = {
    'ts8': ('teapot', 8, True, {}, True),
    'ts8_no_fill_back': ('teapot', 8, False, {}, True),
    'ts16': ('box_jittered', 16, True, {}, True),
    'ts16_no_fill_back': ('box_jittered', 16, False, {}, True),
    'ts8_ambient_only': ('teapot', 8, True,
                         dict(light_intensity_directional=0), True),
    'ts16_edge_on': ('box', 16, True, {}, False),
    'ts8_colours_per_element': ('teapot', 8, True, dict(
        light_intensity_ambient=0.3, light_intensity_directional=0.8,
        light_color_ambient=[[1.0, 0.5, 0.25], [0.2, 0.9, 0.4]],
        light_color_directional=[[0.7, 0.1, 1.0], [1.0, 1.0, 0.3]],
        light_direction=[[0.3, 0.6, -1.0], [-0.5, 1.0, 0.2]]), True),
    'ts8_approx': ('teapot', 8, True, dict(anti_aliasing='approx'), True),
}


def _scene(mesh, ts, seed, jitter):
    v, f = _teapot() if mesh == 'teapot' else _box()
    rng = np.random.default_rng(seed)
    v = v[None] + (rng.normal(0.0, 0.02, (BS,) + v.shape).astype(np.float32)
                   if jitter else np.zeros((BS,) + v.shape, np.float32))
    faces = torch.as_tensor(f)[None].repeat(BS, 1, 1)
    gen = torch.Generator().manual_seed(seed)
    textures = torch.rand((BS, f.shape[0], ts, ts, ts, 3), generator=gen)
    out_grad = torch.rand((BS, 3, IMAGE_SIZE, IMAGE_SIZE), generator=gen)
    return torch.as_tensor(v), faces, textures, out_grad


def _renderer(fill_back, attrs):
    r = nt.Renderer()
    r.image_size = IMAGE_SIZE
    r.fill_back = fill_back
    r.eye = torch.tensor([[1.2, 1.5, -2.0], [-1.8, 0.9, -1.9]])
    for key, value in attrs.items():
        setattr(r, key, torch.tensor(value) if isinstance(value, list)
                else value)
    return r


def _world_faces(r, v, f):
    return vertices_to_faces(v, f, None, r.fill_back)


def _lit_route(r, v, f, t):
    """The lit-cube route: the whole filled cube scaled by the light, then
    ``rasterize`` without a light."""
    world = _world_faces(r, v, f)
    cubes = r._fill_back_textures(t) if r.fill_back else t
    lit = nt.lighting(world, cubes, r.light_intensity_ambient,
                      r.light_intensity_directional, r.light_color_ambient,
                      r.light_color_directional, r.light_direction)
    return nt.rasterize(r._transform_faces(world), lit, r.image_size,
                        r.anti_aliasing, r.near, r.far, r.rasterizer_eps,
                        r.background_color)


def _step(route, r, v, f, t, out_grad):
    v = v.clone().requires_grad_(True)
    t = t.clone().requires_grad_(True)
    tracing.reset()
    image = route(r, v, f, t)
    folded = tracing.counts().get('light.folded', 0)
    gv, gt = torch.autograd.grad((image * out_grad).sum(), [v, t])
    return image.detach(), gv, gt, folded


def _folded_route(r, v, f, t):
    return r.render(v, f, t)


@pytest.mark.parametrize('case', sorted(CASES))
def test_folded_light_matches_lit_cubes(case):
    mesh, ts, fill_back, attrs, jitter = CASES[case]
    r = _renderer(fill_back, attrs)
    v, f, t, out_grad = _scene(mesh, ts, 2700 + ts, jitter)
    img, gv, gt, folded = _step(_folded_route, r, v, f, t, out_grad)
    want_img, want_gv, want_gt, lit_folded = _step(_lit_route, r, v, f, t,
                                                   out_grad)
    assert (folded, lit_folded) == (1, 0)
    # the object covers a good part of each image
    assert float((want_img.sum(1) > 0).float().mean()) > 0.05
    assert torch.equal(img, want_img)
    scale = want_gt.reshape(-1, 3).abs().amax(0)
    assert float(scale.min()) > 0
    err = (gt - want_gt).reshape(-1, 3).abs().amax(0)
    assert bool((err <= SEGMENT_TOL * scale).all()), (err, scale)
    vmax = float(want_gv.abs().max())
    assert vmax > 0
    assert float((gv - want_gv).abs().max()) <= GRAD_TOL * vmax


def test_edge_on_faces_are_drawn():
    """The edge-on case draws faces whose cos is exactly 0 (the tie of
    ``max(cos, 0)``, where the gradient is halved)."""
    _, ts, fill_back, attrs, _ = CASES['ts16_edge_on']
    r = _renderer(fill_back, attrs)
    v, f, _, _ = _scene('box', ts, 2716, False)
    world = _world_faces(r, v, f)
    normals = torch.cross(world[:, :, 0] - world[:, :, 1],
                          world[:, :, 2] - world[:, :, 1], dim=2)
    edge_on = normals[:, :, 1] == 0
    s = RasterizeSettings(image_size=2 * IMAGE_SIZE)
    fim, _ = forward_cuda.forward_face_index_map(s, r._transform_faces(world))
    drawn = torch.zeros_like(edge_on)
    for b in range(BS):
        drawn[b, fim[b][fim[b] >= 0].long()] = True
    assert bool((edge_on & drawn).any())
    light = face_light(world)
    assert bool((light[edge_on] == 0.5).all())


@pytest.mark.parametrize('ts,rgb', [(2, True), (4, True), (8, False)])
def test_a_light_is_refused_where_no_cube_is_sampled(ts, rgb):
    """A light is applied where cubes above ts 4 are sampled in plain
    torch: at ts <= 4 the fused forward and the reduction's K6 read lit
    cubes, and a render without rgb samples none, so ``rasterize_rgbad``
    refuses a light there (the ``Renderer`` lights such cubes itself)."""
    r = _renderer(True, {})
    v, f, t, _ = _scene('teapot', ts, 2740 + ts, True)
    world = _world_faces(r, v, f)
    match = 'are sampled' if rgb else 'needs the rgb drawn'
    with pytest.raises(ValueError, match=match):
        nt.rasterize_rgbad(r._transform_faces(world),
                           r._fill_back_textures(t), r.image_size,
                           return_rgb=rgb, light=face_light(world))


@pytest.mark.parametrize('entry,ts,want', [
    ('render', 4, 0), ('render', 8, 1), ('render_rgbad', 8, 1),
    ('render_silhouettes', 8, 0), ('render_depth', 8, 0)])
def test_light_folded_counts(entry, ts, want):
    """``light.folded`` reads 1 for a render above ts 4 (``render_rgbad``
    as ``render``) and 0 at ts 4, for silhouettes and for depth."""
    r = _renderer(True, {})
    v, f, t, _ = _scene('teapot', ts, 2750, True)
    tracing.reset()
    getattr(r, entry)(*((v, f, t) if entry in ('render', 'render_rgbad')
                        else (v, f)))
    assert tracing.counts().get('light.folded', 0) == want
    tracing.reset()


def test_render_rgbad_folds_as_the_lit_route():
    """``render_rgbad`` above ts 4: rgb, alpha and depth bit-equal to
    ``rasterize_rgbad`` of the lit cubes."""
    r = _renderer(True, {})
    v, f, t, _ = _scene('teapot', 8, 2760, True)
    got = r.render_rgbad(v, f, t)
    fc, lit = r._lit_faces(v, f, t)
    want = nt.rasterize_rgbad(fc, lit, r.image_size, r.anti_aliasing,
                              r.near, r.far, r.rasterizer_eps,
                              r.background_color)
    for k in ('rgb', 'alpha', 'depth'):
        assert torch.equal(got[k], want[k]), k


def test_a_light_of_the_wrong_shape_is_refused():
    r = _renderer(True, {})
    v, f, t, _ = _scene('teapot', 8, 2770, True)
    world = _world_faces(r, v, f)
    with pytest.raises(ValueError, match=r'light must be \[bs, nf, 3\]'):
        nt.rasterize(r._transform_faces(world), r._fill_back_textures(t),
                     r.image_size, light=face_light(world)[:, :-1])
