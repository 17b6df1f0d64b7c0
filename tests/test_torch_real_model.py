"""The port against the JAX package on a real scanned ShapeNet model.

``tests/data/4e49873292196f02574b5684eaec43e9/model.obj``: 921 vertices,
3644 faces, each listed twice with reversed winding, 8 of zero area, 7
materials with Kd colours and two JPEG maps read through Pillow.  After
fill_back each covered pixel lies on four coincident faces: a face, its
reversed twin and their back-filled copies.  Two of them face the camera,
and their depths tie exactly or an ulp apart, so only the z test's
tie-break (the lower index wins a tie) picks the winner, its texel cube and
the face that gets the gradient.

Held here, on the CPU (the port's plain versions):
  * ``load_obj`` at ts 2, 4 and 8: every array equal to the JAX package's;
  * ``render`` at 64^2, AA on and off, ts 2, 4 and 5, from the default eye
    and from ``get_points_from_angles(2, 15, -90)``: rgb within atol 1e-5
    of the JAX package's eager render, coverage equal;
  * the face-index maps of those views (64^2 and the AA raster 128^2) on
    the same NDC faces: equal to the XLA oracle run op by op, and to the
    Pallas ``_tile_kernel`` in interpret mode except on the pixels where
    that kernel and the XLA oracle disagree (pinned below);
  * gradients of ``sum(images * sin(images))`` within test_torch_train.py's
    band (rtol 1e-4, atol 1e-5 x max |grad|), against ``jax.grad`` of the
    eager JAX renderer at 64^2: through the whole renderer from the default
    eye, whose camera rotation is exact in both packages, the textures' and
    the vertices' but those of the grazing faces (pinned below), AA on and
    off; the rasterizer's, to the NDC faces and lit textures, from the side
    eye with AA; the lighting's on a face edge-on to the light;
  * the JAX package's ``test_real_model_gradients_tuned`` at its size
    (128^2 AA, ts 2, the side eye) on the port: ``tune``'s integers equal
    to the JAX package's, finite non-zero gradients, and exact zeros on the
    texels of exactly the faces that win no pixel;
  * ``misc/torch_render.py --device cpu -n 3 -is 32`` over a copy of the
    model's folder and ``tetrahedron.obj``: every PNG written, the model's
    equal to the JAX script's at uint8 (at azimuth 240 through the JAX
    package's camera, pinned below), the tetrahedron white, views in
    batches bit-equal to one view per call, and a textured load that cannot
    read its JPEG map (no Pillow, a broken file, a missing file) raises
    instead of rendering white.

Pinned, neither side wrong (ROADMAP Queue 3):
  * the camera rotation: the JAX package's ``einsum`` and the port's
    elementwise rotation differ by an ulp in NDC, which on this model moves
    a tie and so a winner (and its colour, and the gradient's face);
  * the light cosine: ``jnp.cross`` runs compiled and rounds otherwise than
    the port's cross product, so some faces' cosine is exactly 0 in one
    package only, and its kink moves their vertices' gradients;
  * the JAX package's own two paths: its Pallas kernel's compiled depth on
    2 pixels at 64^2 from eye (2, 15, -90) is an ulp below its XLA
    oracle's, so it picks the back-filled twin where the oracle, and the
    port, pick the face.
"""

import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
import utils
from neural_renderer_torch.io import image as timage
from neural_renderer_torch.ops.transforms import _normalize as torch_normalize
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize.config import RasterizeSettings as TSet
from neural_renderer_tpu.ops.transforms import _normalize as jax_normalize
from neural_renderer_tpu.rasterize import forward_pallas, forward_xla
from neural_renderer_tpu.rasterize.config import RasterizeSettings as JSet

torch.set_num_threads(2)

MODEL_DIR = os.path.join(utils.DATA_DIR, '4e49873292196f02574b5684eaec43e9')
MODEL = os.path.join(MODEL_DIR, 'model.obj')
SCRIPT = os.path.join(os.path.dirname(utils.DATA_DIR), '..', 'misc',
                      'torch_render.py')
NF = 3644
ATOL = 1e-5
# eyes: the default one (None) and the JAX package's real-model tests' one
EYES = {'default': None, 'side': (2.0, 15.0, -90.0)}
# the pixels of the 64^2 side view where the JAX package's Pallas kernel
# and its XLA oracle pick different tied faces
PALLAS_TIE_PIXELS = {('side', 64): [(0, 26, 31), (0, 26, 33)]}


@pytest.fixture(scope='module')
def model():
    """ts -> (vertices, faces, textures) of the port's ``load_obj``."""
    return {ts: nt.load_obj(MODEL, load_texture=True, texture_size=ts)
            for ts in (2, 4, 5, 8)}


def _renderers(eye, image_size, aa=True):
    rj = nr.Renderer()
    rj.image_size = image_size
    rj.anti_aliasing = aa
    if EYES[eye] is not None:
        rj.eye = nr.get_points_from_angles(*EYES[eye])
    return rj, nt.renderer_from_jax(rj, device='cpu')


def _port_ndc(renderer, mesh):
    """The port's NDC faces and lit textures of ``mesh`` (a batch of one)."""
    v, f, t = mesh
    fc, tx = renderer._lit_faces(*nt.arrays_from_numpy(
        v[None], f[None], t[None], device='cpu'))
    return fc.contiguous(), tx.contiguous()


def _jax_ndc(renderer, mesh):
    """The JAX package's NDC faces of ``mesh`` (its own camera transform)."""
    v, f, _ = mesh
    faces = renderer._fill_back_faces(jnp.asarray(f[None]))
    return np.array(renderer._transform_faces(
        nr.vertices_to_faces(jnp.asarray(v[None]), faces)))


@pytest.mark.parametrize('ts', [2, 4, 8])
def test_load_obj_matches_jax(model, ts):
    got = model[ts]
    want = nr.load_obj(MODEL, load_texture=True, texture_size=ts)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    v, f, t = got
    assert v.shape == (921, 3) and f.shape == (NF, 3)
    assert t.shape == (NF, ts, ts, ts, 3)
    assert np.isfinite(t).all() and 0.0 <= t.min() and t.max() <= 1.0
    assert t.reshape(-1, 3).std(0).max() > 0.05       # several materials
    # every face has its reversed twin; 8 have zero area
    listed = {tuple(x) for x in f}
    assert all({(a, c, b), (c, b, a), (b, a, c)} & listed for a, b, c in f)
    area = np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]],
                                   v[f[:, 2]] - v[f[:, 0]]), axis=1)
    assert (area == 0).sum() == 8


@pytest.mark.parametrize('eye', list(EYES))
@pytest.mark.parametrize('aa', [False, True])
@pytest.mark.parametrize('ts', [2, 4, 5])
def test_render_matches_jax(model, eye, aa, ts):
    v, f, t = model[ts]
    rj, rt = _renderers(eye, 64, aa)
    want = np.asarray(rj.render(v[None], f[None], t[None]))
    got = rt.render(*nt.arrays_from_numpy(v[None], f[None], t[None],
                                          device='cpu')).numpy()
    assert got.shape == want.shape == (1, 3, 64, 64)
    np.testing.assert_array_equal(got.max(1) > 0, want.max(1) > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (want.max(1) > 0.05).mean() > 0.05


@pytest.mark.parametrize('eye', list(EYES))
@pytest.mark.parametrize('raster', [64, 128])
def test_face_index_map_matches_jax(model, eye, raster):
    """The rasterizer's maps of the port on its own NDC faces against the
    JAX package's XLA oracle (op by op) and Pallas kernel (interpret mode)
    on the same faces."""
    _, rt = _renderers(eye, raster, aa=False)
    fc, tx = _port_ndc(rt, model[2])
    out = forward_cuda.forward_shaded(TSet(image_size=raster), fc, tx)
    idx = out['face_index_map'].numpy()
    js = JSet(image_size=raster, runtime_checks=False,
              faces_per_tile_cap=fc.shape[1])
    with jax.disable_jit():
        xi, xd = (np.asarray(a) for a in forward_xla.forward_face_index_map(
            js, jnp.asarray(fc.numpy())))
    pi, pd = (np.asarray(a) for a in forward_pallas.forward_face_index_map(
        js, jnp.asarray(fc.numpy()), interpret=True))
    np.testing.assert_array_equal(idx, xi)
    # the index path (tune's): the same winners and the oracle's raw depth
    ii, idepth = forward_cuda.forward_face_index_map(
        TSet(image_size=raster), fc)
    np.testing.assert_array_equal(ii.numpy(), xi)
    np.testing.assert_array_equal(idepth.numpy(), xd)
    covered = idx >= 0
    assert covered.sum() > 0.05 * raster * raster
    # the ties: every winner is one of the model's own faces (the face
    # beats its reversed twin's back-filled copy at equal depth)
    assert (idx[covered] < NF).all()
    # Pallas: equal but where it and the XLA oracle disagree
    differ = [tuple(int(i) for i in p) for p in np.argwhere(pi != xi)]
    assert differ == PALLAS_TIE_PIXELS.get((eye, raster), [])
    f = model[2][1]
    corners = np.concatenate([f, f[:, ::-1]])
    for p in differ:
        # the same triangle, its depth an ulp nearer in the kernel
        assert set(corners[pi[p]]) == set(corners[xi[p]])
        assert pi[p] >= NF and pd[p] < xd[p]
        np.testing.assert_allclose(pd[p], xd[p], rtol=3e-7)
    np.testing.assert_array_equal(np.delete(idx.ravel(), [
        np.ravel_multi_index(p, idx.shape) for p in differ]),
        np.delete(pi.ravel(), [np.ravel_multi_index(p, pi.shape)
                               for p in differ]))


def _assert_band(got, want, name):
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=name)


def _loss_j(images):
    return jnp.sum(images * jnp.sin(images))


def _loss_t(images):
    return (images * torch.sin(images)).sum()


def _grazing_vertices(mesh):
    """The vertices of the faces (fill_back included) whose light cosine is
    exactly 0 in one package and not in the other, or positive in one only:
    ``jnp.cross`` runs compiled and rounds a * b - c * d in other ways than
    the port's separately rounded products, and the cosine's kink turns
    that ulp into a whole directional term of the vertex gradient."""
    v, f, _ = mesh
    faces = np.concatenate([f, f[:, ::-1]])
    fc = v[faces]
    a, b = fc[:, 0] - fc[:, 1], fc[:, 2] - fc[:, 1]
    cos_j = np.asarray(jax_normalize(jnp.cross(jnp.asarray(a),
                                               jnp.asarray(b))))[:, 1]
    cos_t = torch_normalize(nt.cross(torch.as_tensor(a),
                                     torch.as_tensor(b))).numpy()[:, 1]
    moved = ((cos_j == 0) != (cos_t == 0)) | ((cos_j > 0) != (cos_t > 0))
    return set(faces[moved].ravel())


@pytest.mark.parametrize('aa', [False, True])
def test_render_grads_match_jax(model, aa):
    """The whole renderer at 64^2 from the default eye, whose camera
    rotation is exact in both packages: texture gradients within the band
    everywhere, vertex gradients on every vertex but the grazing ones."""
    v, f, t = model[2]
    rj, rt = _renderers('default', 64, aa)
    want = jax.grad(lambda a, b: _loss_j(rj.render(a, f[None], b)),
                    argnums=(0, 1))(jnp.asarray(v[None]),
                                    jnp.asarray(t[None]))
    vt, ft, tt = nt.arrays_from_numpy(v[None], f[None], t[None],
                                      device='cpu')
    vt.requires_grad_()
    tt.requires_grad_()
    _loss_t(rt.render(vt, ft, tt)).backward()
    _assert_band(tt.grad.numpy(), np.asarray(want[1]), 'textures')
    grazing = sorted(_grazing_vertices(model[2]))
    assert 0 < len(grazing) < 0.2 * v.shape[0]
    keep = np.setdiff1d(np.arange(v.shape[0]), grazing)
    want_v = np.asarray(want[0])[0]
    np.testing.assert_allclose(vt.grad.numpy()[0, keep], want_v[keep],
                               rtol=1e-4, atol=1e-5 * np.abs(want_v).max(),
                               err_msg='vertices')


def test_rasterizer_grads_match_jax(model):
    """The side eye at 64^2 AA, on the same NDC faces and lit textures:
    the rasterizer's gradients to both within the band."""
    _, rt = _renderers('side', 64)
    fc, tx = _port_ndc(rt, model[2])
    fc, tx = fc.detach(), tx.detach()
    want = jax.grad(lambda a, b: _loss_j(nr.rasterize(a, b, 64)),
                    argnums=(0, 1))(jnp.asarray(fc.numpy()),
                                    jnp.asarray(tx.numpy()))
    fc.requires_grad_()
    tx.requires_grad_()
    _loss_t(nt.rasterize(fc, tx, 64)).backward()
    _assert_band(fc.grad.numpy(), np.asarray(want[0]), 'faces')
    _assert_band(tx.grad.numpy(), np.asarray(want[1]), 'textures')


def test_lighting_gradient_of_an_edge_on_face_matches_jax():
    """A face whose normal is exactly perpendicular to the light (cos 0,
    as on the model's axis-aligned sides): max(cos, 0) passes half the
    gradient in the JAX package (jnp.maximum's tie) and in the port."""
    faces = np.array([[[[0., 0., 0.], [1., 0., 0.], [0., 0., 1.]],
                       [[0., 0., 0.], [0., 0., 1.], [1., 0., 0.]],
                       [[0., 0., 0.], [1., 0., 0.], [0., 1., 0.]]]],
                     np.float32)
    tex = np.random.RandomState(0).uniform(
        0, 1, (1, 3, 2, 2, 2, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(nr.lighting(a, jnp.asarray(tex))))(
        jnp.asarray(faces))
    ft = torch.tensor(faces, requires_grad=True)
    nt.lighting(ft, torch.as_tensor(tex)).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    assert np.abs(ft.grad.numpy()[0, 2]).max() > 0


def test_real_model_gradients_tuned(model):
    """The JAX test at its size (128^2 AA, ts 2, the side eye) on the port:
    tune's dict, finite non-zero gradients, and exact zeros on the texels
    of exactly the faces that win no pixel."""
    v, f, t = model[2]
    rj, rt = _renderers('side', 128)
    assert nt.tune(rt, torch.as_tensor(v), torch.as_tensor(f)) == nr.tune(
        rj, jnp.asarray(v), jnp.asarray(f))
    assert rt.perf_overrides['faces_per_tile_cap'] >= 128
    vt, ft, tt = nt.arrays_from_numpy(v[None], f[None], t[None],
                                      device='cpu')
    vt.requires_grad_()
    tt.requires_grad_()
    _loss_t(rt.render(vt, ft, tt)).backward()
    gv, gt = vt.grad.numpy(), tt.grad.numpy()
    assert np.isfinite(gv).all() and np.isfinite(gt).all()
    assert np.abs(gv).max() > 0 and np.abs(gt).max() > 0
    fc, _ = _port_ndc(rt, model[2])
    fim = forward_cuda.forward_face_index_map(TSet(image_size=256),
                                              fc.detach())[0].numpy()
    shown = np.zeros(2 * NF, bool)
    shown[fim[fim >= 0]] = True
    seen = shown[:NF] | shown[NF:]           # a face or its back-filled copy
    zero = np.abs(gt).reshape(NF, -1).max(1) == 0
    assert zero.any() and not zero.all()
    np.testing.assert_array_equal(zero, ~seen)


# ---- misc/torch_render.py ----

@pytest.fixture(scope='module')
def script():
    spec = importlib.util.spec_from_file_location('torch_render', SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def dataset(tmp_path):
    """A copy of the model's folder and the tetrahedron (no mtllib)."""
    root = tmp_path / 'in'
    shutil.copytree(MODEL_DIR, root / 'shapenet' / 'model_a')
    shutil.copy(os.path.join(utils.DATA_DIR, 'tetrahedron.obj'), root)
    return root


def _uint8(image):
    return (np.clip(image, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def _jax_views(path, textures, azimuths, lit=None):
    """The JAX script's images [n, 3, 32, 32] (its renderer run eagerly);
    with ``lit`` (the port's lit textures) the JAX package's NDC faces go
    through the port's rasterizer instead."""
    v, f = nr.load_obj(path)
    r = nr.Renderer()
    r.image_size = 32
    out = []
    for az in azimuths:
        r.eye = jnp.asarray(nr.get_points_from_angles(
            np.float32(2.732), np.float32(30.0), np.float32(az)))
        if lit is None:
            out.append(np.asarray(r.render(v[None], f[None],
                                           textures[None]))[0])
        else:
            out.append(nt.rasterize(torch.as_tensor(_jax_ndc(r, (v, f, None))),
                                    lit, 32).numpy()[0])
    return np.stack(out)


def _pngs(images):
    return [_uint8(image.transpose(1, 2, 0)) for image in images]


def test_torch_render_writes_the_jax_scripts_views(script, dataset, tmp_path):
    out = tmp_path / 'out'
    paths = script.run(['-i', str(dataset), '-o', str(out), '-n', '3',
                        '-is', '32', '--device', 'cpu'])
    names = [f'shapenet_model_a_model_{i:02d}.png' for i in range(3)] + \
        [f'tetrahedron_{i:02d}.png' for i in range(3)]
    assert paths == [str(out / n) for n in names]
    assert sorted(os.listdir(out)) == sorted(names)
    got = [timage.imread(p) for p in paths]
    assert all(g.shape == (32, 32, 3) and g.dtype == np.uint8 for g in got)
    azimuths = (0.0, 120.0, 240.0)

    model_obj = str(dataset / 'shapenet' / 'model_a' / 'model.obj')
    _, _, t = nr.load_obj(model_obj, load_texture=True, texture_size=2)
    want = _pngs(_jax_views(model_obj, t, azimuths))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # azimuth 240: the two packages' camera rotations differ by an ulp,
    # which moves ties (pinned); the JAX package's NDC faces through the
    # port's rasterizer give its image
    assert (got[2] != want[2]).any()
    lit = _port_ndc(nt.Renderer(), nt.load_obj(
        model_obj, load_texture=True, texture_size=2))[1]
    np.testing.assert_array_equal(
        _pngs(_jax_views(model_obj, t, azimuths[2:], lit))[0], want[2])

    # the tetrahedron (no mtllib) in white: the port's own white render,
    # and the JAX script's within the renderers' atol (an ulp of the
    # camera flips a few x.5 / 255 values at uint8)
    tetra = str(dataset / 'tetrahedron.obj')
    white = np.ones((1, 4, 2, 2, 2, 3), np.float32)
    r = nt.Renderer()
    r.image_size = 32
    mine = script.render_views(
        r, *nt.arrays_from_numpy(nt.load_obj(tetra)[0][None],
                                 nt.load_obj(tetra)[1][None], white,
                                 device='cpu'),
        script.view_eyes(3, 2.732, 30.0, 'cpu'))
    np.testing.assert_array_equal(np.stack(got[3:]), np.stack(_pngs(mine)))
    np.testing.assert_allclose(mine, _jax_views(tetra, white[0], azimuths),
                               rtol=0, atol=ATOL)


def test_torch_render_batches_equal_single_views(script, model, monkeypatch):
    v, f, t = nt.arrays_from_numpy(*(a[None] for a in model[2]),
                                   device='cpu')
    r = nt.Renderer()
    r.image_size = 32
    eyes = script.view_eyes(5, 2.732, 30.0, 'cpu')
    monkeypatch.setattr(script, 'MAX_VIEWS', 3)     # batches of 3 and 2
    batched = script.render_views(r, v, f, t, eyes)
    single = np.concatenate([script.render_views(r, v, f, t, eyes[i:i + 1])
                             for i in range(5)])
    assert batched.shape == (5, 3, 32, 32)
    assert np.array_equal(batched, single)
    assert len({a.tobytes() for a in batched}) == 5


def _no_pillow(what):
    raise ImportError(f'{what} needs Pillow, which is not installed')


@pytest.mark.parametrize('fault', ['no pillow', 'broken jpeg', 'missing map'])
def test_torch_render_raises_on_texture_faults(script, dataset, tmp_path,
                                               monkeypatch, fault):
    images = dataset / 'shapenet' / 'model_a' / 'images'
    if fault == 'no pillow':
        monkeypatch.setattr(timage, '_pillow', _no_pillow)
        error = ImportError
    elif fault == 'broken jpeg':
        (images / 'texture0.jpg').write_bytes(b'\xff\xd8\xff\xe0 not a jpeg')
        error = OSError
    else:
        (images / 'texture1.jpg').unlink()
        error = FileNotFoundError
    with pytest.raises(error):
        script.run(['-i', str(dataset), '-o', str(tmp_path / 'out'),
                    '-n', '1', '-is', '16', '--device', 'cpu'])
