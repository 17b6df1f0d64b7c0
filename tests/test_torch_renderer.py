"""The whole forward slice of the port against the JAX package and the goldens.

``Renderer.render`` / ``render_silhouettes`` / ``render_depth`` of
``neural_renderer_torch`` on the CPU (plain versions of the kernels) against
the same methods of ``neural_renderer_tpu`` on the teapot test batch at 64^2,
anti-aliasing on and off, ts 2, 4 and 5: allclose at atol 1e-5 and coverage
masks exactly equal.  The JAX methods run eagerly, op by op as the port does:
under ``jax.jit`` XLA's CPU fusion rounds the barycentric products of sliver
faces differently (ROADMAP Queue 3).  Also the Blender silhouette golden, the
AA rgb fingerprint, ``renderer_from_jax``, input checks and background
colours.  The backward is held against the JAX package in
test_torch_backward.py and test_torch_train.py.
"""

import os

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
import utils

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(scope='module')
def teapot():
    """The teapot batch of tests/utils.py (rows 0, 1, 3 all-zero meshes)
    with random textures of ts 2, 4 and 5 from a numpy seed (ts 5 is
    shaded after the forward maps, as in the JAX package)."""
    vertices, faces, _ = utils.load_teapot_batch()
    rng = np.random.RandomState(11)
    tex = {ts: rng.uniform(0.1, 1, (4, faces.shape[1], ts, ts, ts, 3)
                           ).astype(np.float32) for ts in (2, 4, 5)}
    return vertices, faces, tex


def _pair(aa, image_size=64):
    rj = nr.Renderer()
    rj.image_size = image_size
    rj.anti_aliasing = aa
    return rj, nt.renderer_from_jax(rj, device='cpu')


@pytest.mark.parametrize('aa', [False, True])
@pytest.mark.parametrize('ts', [2, 4, 5])
def test_render_matches_jax(teapot, aa, ts):
    vertices, faces, tex = teapot
    rj, rt = _pair(aa)
    want = np.asarray(rj.render(vertices, faces, tex[ts]))
    got = rt.render(*nt.arrays_from_numpy(vertices, faces, tex[ts],
                                          device='cpu')).numpy()
    assert got.shape == want.shape == (4, 3, 64, 64)
    np.testing.assert_array_equal(got.max(1) > 0, want.max(1) > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert want[2].max() > 0.5 and want[[0, 1, 3]].max() == 0


@pytest.mark.parametrize('aa', [False, True])
def test_render_silhouettes_matches_jax(teapot, aa):
    vertices, faces, _ = teapot
    rj, rt = _pair(aa)
    want = np.asarray(rj.render_silhouettes(vertices, faces))
    got = rt.render_silhouettes(
        *nt.arrays_from_numpy(vertices, faces, device='cpu')[:2]).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize('aa', [False, True])
def test_render_depth_matches_jax(teapot, aa):
    vertices, faces, _ = teapot
    rj, rt = _pair(aa)
    want = np.asarray(rj.render_depth(vertices, faces))
    got = rt.render_depth(
        *nt.arrays_from_numpy(vertices, faces, device='cpu')[:2]).numpy()
    far = nt.DEFAULT_FAR
    np.testing.assert_array_equal(got < far, want < far)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_blender_golden(teapot):
    """Silhouette of a textured render vs Blender's (the JAX
    test_forward_case3_blender_golden settings, tests/test_rasterize.py)."""
    vertices, faces, _ = teapot
    textures = np.ones((4, faces.shape[1], 4, 4, 4, 3), np.float32)
    r = nt.Renderer()
    r.image_size = 256
    r.anti_aliasing = False
    r.light_intensity_ambient = 1.0
    r.light_intensity_directional = 0.0
    images = r.render(*nt.arrays_from_numpy(vertices, faces, textures,
                                            device='cpu'))
    image = images[2].mean(0).numpy()
    np.testing.assert_allclose(utils.load_blender_silhouette(), image,
                               rtol=1e-4, atol=1e-5)


def test_aa_rgb_fingerprint(teapot):
    """Default anti-aliased textured render at eye [1, 1, -2.7] vs the stored
    fingerprint (tests/test_rasterize.py test_forward_case2)."""
    vertices, faces, _ = teapot
    ref = np.load(os.path.join(utils.DATA_DIR,
                               'teapot_aa_rgb_fingerprint.npz'))
    textures = np.ones((4, faces.shape[1], 4, 4, 4, 3), np.float32)
    r = nt.Renderer()
    r.eye = [1.0, 1.0, -2.7]
    images = r.render(*nt.arrays_from_numpy(vertices, faces, textures,
                                            device='cpu')).numpy()
    np.testing.assert_allclose(images[2], ref['image'], atol=1e-5, rtol=0)
    assert images[[0, 1, 3]].max() == 0


def test_renderer_from_jax(teapot):
    vertices, faces, tex = teapot
    rj = nr.Renderer()
    rj.image_size = 64
    rj.anti_aliasing = False
    rj.camera_mode = 'look'
    rj.eye = np.array([0.4, 0.5, -2.6], np.float32)
    rj.camera_direction = [-0.1, -0.15, 1.0]
    rj.light_direction = [0.3, 1.0, -0.2]
    rj.light_intensity_ambient = 0.35
    rj.light_color_directional = [1.0, 0.8, 0.6]
    rj.background_color = [0.2, 0.3, 0.4]
    rj.viewing_angle = 27
    rt = nt.renderer_from_jax(rj, device='cpu')
    for name in ('camera_mode', 'camera_direction', 'light_direction',
                 'light_intensity_ambient', 'light_color_directional',
                 'background_color', 'viewing_angle', 'image_size',
                 'anti_aliasing', 'fill_back', 'near', 'far',
                 'rasterizer_eps'):
        assert getattr(rt, name) == getattr(rj, name), name
    assert isinstance(rt.eye, torch.Tensor)
    np.testing.assert_array_equal(rt.eye.numpy(), rj.eye)
    # uniform cubes: the rgb then does not depend on the barycentric
    # weights, which the 1-ulp differences between the JAX einsum and the
    # port's elementwise 'look' rotation move by up to 1e-4 on sliver faces
    # (ROADMAP Queue 3)
    textures = np.ones_like(tex[2])
    want = np.asarray(rj.render(vertices, faces, textures))
    got = rt.render(*nt.arrays_from_numpy(vertices, faces, textures,
                                          device='cpu')).numpy()
    bg = np.array([0.2, 0.3, 0.4], np.float32)[:, None, None]
    np.testing.assert_array_equal(np.abs(got - bg).max(1) > 0,
                                  np.abs(want - bg).max(1) > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the background shows where the teapot rows are empty
    np.testing.assert_allclose(got[0, :, 0, 0], [0.2, 0.3, 0.4], atol=1e-6)


def test_arrays_from_mesh_batch():
    """Mesh arrays from the JAX Mesh.get_batch, converted with np.asarray."""
    mesh = nr.Mesh.from_obj(os.path.join(utils.DATA_DIR, 'tetrahedron.obj'),
                            texture_size=2)
    v, f, t = (np.asarray(a) for a in mesh.get_batch(3))
    vt, ft, tt = nt.arrays_from_numpy(v, f, t, device='cpu')
    assert vt.dtype == torch.float32 and tt.dtype == torch.float32
    assert ft.dtype == torch.int64
    np.testing.assert_array_equal(vt.numpy(), v)
    np.testing.assert_array_equal(ft.numpy(), f)
    np.testing.assert_array_equal(tt.numpy(), t)


def test_background_colors():
    """Static [3] and per-batch [bs, 3] background colors
    (reference rasterize.py:462-465)."""
    v = np.tile(np.array(
        [[0.5, 0.5, 1.], [-0.5, -0.5, 1.], [0.5, -0.5, 1.]], np.float32),
        (3, 1, 1, 1))
    tx = np.zeros((3, 1, 2, 2, 2, 3), np.float32)
    for bg in [(0.25, 0.5, 0.75), np.eye(3, dtype=np.float32)]:
        want = np.asarray(nr.rasterize(v, tx, image_size=16,
                                       anti_aliasing=False,
                                       background_color=bg))
        got = nt.rasterize(torch.as_tensor(v), torch.as_tensor(tx),
                           image_size=16, anti_aliasing=False,
                           background_color=bg).numpy()
        np.testing.assert_array_equal(got, want)


def test_rasterize_class_and_rgbad():
    """The Rasterize compat class (no AA) equals rasterize_rgbad without AA,
    in raster space before the flip."""
    rng = np.random.RandomState(3)
    fc = rng.uniform(-0.9, 0.9, (2, 20, 3, 3)).astype(np.float32)
    fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
    tx = rng.uniform(0, 1, (2, 20, 2, 2, 2, 3)).astype(np.float32)
    ras = nt.Rasterize(32, 0.1, 100, 1e-3, [0, 0, 0], return_rgb=True,
                       return_alpha=True, return_depth=True)
    rgb, alpha, depth = ras(torch.as_tensor(fc), torch.as_tensor(tx))
    out = nt.rasterize_rgbad(torch.as_tensor(fc), torch.as_tensor(tx), 32,
                             False, 0.1, 100, 1e-3)
    np.testing.assert_array_equal(
        torch.flip(rgb.permute(0, 3, 1, 2), dims=[2]).numpy(),
        out['rgb'].numpy())
    np.testing.assert_array_equal(torch.flip(alpha, dims=[1]).numpy(),
                                  out['alpha'].numpy())
    np.testing.assert_array_equal(torch.flip(depth, dims=[1]).numpy(),
                                  out['depth'].numpy())


def test_input_validation():
    """Reference-style shape/dtype checks (rasterize.py:66-90)."""
    good_f = torch.zeros((2, 5, 3, 3))
    good_t = torch.zeros((2, 5, 2, 2, 2, 3))
    with pytest.raises(ValueError, match='faces must be'):
        nt.rasterize_silhouettes(torch.zeros((2, 5, 3)), image_size=16)
    with pytest.raises(ValueError, match='textures must be'):
        nt.rasterize(good_f, torch.zeros((2, 5, 2, 2, 2, 4)), image_size=16)
    with pytest.raises(ValueError, match='ts >= 2'):
        nt.rasterize(good_f, torch.zeros((2, 5, 1, 1, 1, 3)), image_size=16)
    with pytest.raises(ValueError, match='agree'):
        nt.rasterize(good_f, torch.zeros((2, 4, 2, 2, 2, 3)), image_size=16)
    with pytest.raises(ValueError, match='background_color'):
        nt.rasterize(good_f, good_t, image_size=16,
                     background_color=(1.0, 0.0))
