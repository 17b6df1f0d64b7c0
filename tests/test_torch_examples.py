"""The port's examples and gradient-quality study against the JAX package.

Examples 2, 3 and 4 take three steps at 64^2 through their own functions
(``build``, ``step``) on the CPU, against the same loop written here with
the JAX package and run eagerly; the reference image is the JAX package's
render of the teapot from another eye (azimuth -15, elevation 30, as
``examples/example4.py``'s ``-mr`` makes it).  Losses agree within rtol
1e-5, the vertices (example 2) and the eye (example 4) within 1e-5 x their
max |value|; example 3 draws the same azimuths from the seed, and its
textures hold to a looser contract, stated at the check.  Also: example
2's step-0 loss at its own size (256^2 AA) equals the JAX package's,
example 1's sweep at 64^2 equals the JAX render, and
``misc/torch_grad_quality.py``'s 8 rows equal ``misc/grad_quality.py``'s.
"""

import contextlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
from neural_renderer_tpu.io.image import imread as nr_imread
from neural_renderer_tpu.io.image import imsave01 as nr_imsave01

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'examples', 'data')
TEAPOT = os.path.join(DATA, 'teapot.obj')
IS = 64
STEPS = 3
# example 2's step-0 loss at 256^2 AA: the JAX package on the CPU, jitted
# and eager alike
EXAMPLE2_STEP0 = 10103.125


def _load(path):
    name = 'test_' + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example(n):
    return _load(os.path.join(ROOT, 'examples', f'torch_example{n}.py'))


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """A 64^2 reference PNG: the JAX package's rgb render of the teapot
    (white textures under tanh) from azimuth -15, elevation 30."""
    v, f = nr.load_obj(TEAPOT)
    r = nr.Renderer()
    r.image_size = IS
    r.eye = nr.get_points_from_angles(2.732, 30, -15)
    images = r.render(v[None], f[None],
                      np.tanh(np.ones((1, f.shape[0], 2, 2, 2, 3),
                                      np.float32)))
    path = str(tmp_path_factory.mktemp('ref') / 'ref.png')
    nr_imsave01(path, np.asarray(images)[0].transpose(1, 2, 0))
    return path


def _assert_close(losses_t, losses_j, param_t, param_j):
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    param_j = np.asarray(param_j)
    np.testing.assert_allclose(param_t.detach().numpy(), param_j, rtol=0,
                               atol=1e-5 * np.abs(param_j).max())


def _jax_fit(mesh, loss_fn, steps_args, **adam):
    """Eager JAX Adam steps of ``loss_fn(mesh, *args)``: (losses, mesh)."""
    init_fn, update_fn = nr.adam(lr_scales=mesh.lr_scales(), **adam)
    state = init_fn(mesh)
    losses = []
    for args in steps_args:
        loss, grads = jax.value_and_grad(loss_fn)(mesh, *args)
        updates, state = update_fn(grads, state)
        mesh = jax.tree.map(lambda p, u: p + u, mesh, updates)
        losses.append(float(loss))
    return losses, mesh


def test_example2_steps_match_jax(reference):
    ex = _example(2)
    mesh, renderer, image_ref = ex.build(TEAPOT, reference, 'cpu')
    assert renderer.image_size == IS
    optimizer = nt.Adam(mesh.lr_scales())
    losses = [ex.step(mesh, renderer, image_ref, optimizer)
              for _ in range(STEPS)]

    v, f = nr.load_obj(TEAPOT)
    mj = nr.Mesh(vertices=jnp.asarray(v), faces=f, textures=jnp.ones(
        (f.shape[0], 2, 2, 2, 3), jnp.float32))
    rj = nr.Renderer()
    rj.image_size = IS
    rj.eye = nr.get_points_from_angles(2.732, 0, 90)
    ref = jnp.asarray(nr_imread(reference).astype('float32').mean(-1) / 255.0)

    def loss_j(m):
        image = rj.render_silhouettes(m.vertices[None], m.faces[None])
        return jnp.sum(jnp.square(image - ref[None]))

    losses_j, mj = _jax_fit(mj, loss_j, [()] * STEPS)
    _assert_close(losses, losses_j, mesh.vertices, mj.vertices)
    # the textures got no gradient and stayed white
    assert mesh.textures.grad is None
    assert float(mesh.textures.detach().min()) == 1.0


def test_example3_steps_match_jax(reference):
    ex = _example(3)
    mesh, renderer, image_ref = ex.build(TEAPOT, reference, 'cpu')
    optimizer = nt.Adam(mesh.lr_scales(), alpha=0.1, beta1=0.5)
    rng = np.random.default_rng(0)
    azimuths = [rng.uniform(0, 360) for _ in range(STEPS)]
    losses = [ex.step(mesh, renderer, image_ref, optimizer, a)
              for a in azimuths]

    v, f = nr.load_obj(TEAPOT)
    mj = nr.Mesh(vertices=jnp.asarray(v), faces=f, textures=jnp.zeros(
        (f.shape[0], 4, 4, 4, 3), jnp.float32)).set_lr(0.0, 1.0)
    rj = nr.Renderer()
    rj.image_size = IS
    rj.perspective = False
    rj.light_intensity_directional = 0.0
    rj.light_intensity_ambient = 1.0
    ref = jnp.asarray(nr_imread(reference).astype('float32') / 255.0)

    def loss_j(m, eye):
        rj.eye = eye
        image = rj.render(m.vertices[None], m.faces[None],
                          jnp.tanh(m.textures)[None])
        return jnp.sum(jnp.square(image - ref.transpose(2, 0, 1)[None]))

    eyes = [(jnp.asarray(nr.get_points_from_angles(
        np.float32(2.732), np.float32(0), np.float32(a))),)
        for a in azimuths]
    losses_j, mj = _jax_fit(mj, loss_j, eyes, alpha=0.1, beta1=0.5)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    # Adam scales each texel's step by its own gradient history, so a texel
    # whose first gradient is tiny (~5e-6 x max) moves by most of a step
    # however small it is, and the two packages' gradients there differ by
    # ~1e-6 x max (the camera rotation, ROADMAP Queue 3): held to the
    # face-parallel contract's share, under 0.5% of the texels beyond
    # 1e-5 x max |texture|, and all within 5% of one step (alpha 0.1)
    got, want = mesh.textures.detach().numpy(), np.asarray(mj.textures)
    beyond = np.abs(got - want) > 1e-5 * np.abs(want).max()
    assert beyond.mean() < 0.005, beyond.mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * 0.1)
    # the vertices are frozen by their learning-rate scale of 0
    np.testing.assert_array_equal(mesh.vertices.detach().numpy(), v)


def test_example4_steps_match_jax(reference):
    ex = _example(4)
    vertices, faces, _, renderer, image_ref, eye = ex.build(
        TEAPOT, reference, 'cpu')
    init_fn, update_fn = nt.adam(alpha=0.1)
    state = init_fn({'eye': eye})
    losses = []
    for _ in range(STEPS):
        loss, state = ex.step(eye, state, update_fn, renderer, vertices,
                              faces, image_ref)
        losses.append(loss)

    v, f = nr.load_obj(TEAPOT)
    rj = nr.Renderer()
    rj.image_size = IS
    ref = jnp.asarray((nr_imread(reference).max(-1) != 0).astype('float32'))

    def loss_j(cam):
        rj.eye = cam
        image = rj.render_silhouettes(v[None], f[None])
        return jnp.sum(jnp.square(image - ref[None]))

    init_j, update_j = nr.adam(alpha=0.1)
    cam = jnp.array([6.0, 10.0, -14.0], jnp.float32)
    state_j = init_j(cam)
    losses_j = []
    for _ in range(STEPS):
        loss, g = jax.value_and_grad(loss_j)(cam)
        updates, state_j = update_j(g, state_j)
        cam = cam + updates
        losses_j.append(float(loss))
    _assert_close(losses, losses_j, eye, cam)


def test_example4_reference_image_matches_the_repos(tmp_path):
    """``-mr``'s reference image, rendered by the port at 256^2 AA, has the
    silhouette of ``examples/data/example4_ref.png``."""
    ex = _example(4)
    path = str(tmp_path / 'ref.png')
    ex.make_reference_image(path, TEAPOT, 'cpu')
    got = nt.io.image.imread(path)
    want = nr_imread(os.path.join(DATA, 'example4_ref.png'))
    assert got.shape == want.shape == (256, 256, 3)
    assert ((got.max(-1) != 0) != (want.max(-1) != 0)).sum() == 0


def test_example2_step0_loss_at_full_size():
    ex = _example(2)
    mesh, renderer, image_ref = ex.build(
        TEAPOT, os.path.join(DATA, 'example2_ref.png'), 'cpu')
    assert renderer.image_size == 256 and renderer.anti_aliasing
    with torch.no_grad():
        loss = float(ex.loss_fn(mesh, renderer, image_ref))
    np.testing.assert_allclose(loss, EXAMPLE2_STEP0, rtol=1e-5)


def test_example1_sweep_matches_jax():
    ex = _example(1)
    vertices, faces, textures, renderer = ex.build(TEAPOT, 'cpu')
    renderer.image_size = IS
    azimuths = [0, 120, 244]
    got = ex.render_sweep(renderer, vertices, faces, textures, azimuths)
    v, f = nr.load_obj(TEAPOT)
    rj = nr.Renderer()
    rj.image_size = IS
    want = []
    for a in azimuths:
        rj.eye = nr.get_points_from_angles(np.float32(2.732), np.float32(30),
                                           np.float32(a))
        want.append(np.asarray(rj.render(
            v[None], f[None], np.ones((1, f.shape[0], 2, 2, 2, 3),
                                      np.float32)))[0])
    assert got.shape == (3, 3, IS, IS)
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-5)


def test_grad_quality_rows_match_jax():
    gq_jax = _load(os.path.join(ROOT, 'misc', 'grad_quality.py'))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gq_jax.main()
    # its table: pixel, where, loss, dist, |grad|, gx(v0), 5 decimals
    want = [(int(p[0]), float(p[4]), float(p[5]))
            for p in (line.split() for line in out.getvalue().splitlines())
            if len(p) == 6 and p[0].isdigit()]
    with contextlib.redirect_stdout(io.StringIO()):
        rows, g_brighter, g_darker = _load(os.path.join(
            ROOT, 'misc', 'torch_grad_quality.py')).run(['--device', 'cpu'])
    assert [r[0] for r in rows] == [w[0] for w in want] and len(rows) == 8
    np.testing.assert_allclose([r[1:] for r in rows], [w[1:] for w in want],
                               rtol=1e-5, atol=5e-6)
    assert g_brighter[0, 0] > 0 and np.all(g_darker == 0)
