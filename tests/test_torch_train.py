"""The port's training path against the JAX package.

``torch.autograd`` gradients of ``Renderer.render`` (AA on and off, ts 2, 4
and 5), ``render_silhouettes``, ``render_depth`` and ``render_rgbad``, with
respect to vertices and textures, against ``jax.grad`` of the same JAX
methods run eagerly (ROADMAP Queue 3), on the teapot at 64^2 (a batch of the
teapot and an all-zero mesh) with random textures and loss weights from a
numpy seed: rtol 1e-4, atol 1e-5 x max |grad| (sums run in other orders:
the out-sweep, the per-face reduction, the vertex scatter, the camera
rotation).  Also ``anti_aliasing='approx'`` (values bit for bit those of
True, gradients bit for bit those of the 1x render), ``Adam`` against
``neural_renderer_tpu.adam``, ``Mesh`` through ``mesh_from_jax`` against the
JAX ``Mesh``, three Adam steps on a teapot mesh against the JAX package
from the same seed (losses rtol 1e-5; parameters atol 2e-4, 2% of one
step of alpha 0.01), and the ``Rasterize`` class, whose backward equals
``rasterize_rgbad``'s bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
import utils

torch.set_num_threads(2)

IS = 64
TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')


@pytest.fixture(scope='module')
def batch():
    """The teapot (row 1) beside an all-zero mesh (row 0)."""
    v, f, _ = utils.load_teapot_batch(batch_size=2, target_num=1)
    return v, f


def _renderers(aa, eye=None):
    rj = nr.Renderer()
    rj.image_size = IS
    rj.anti_aliasing = aa
    if eye is not None:
        rj.eye = eye
    return rj, nt.renderer_from_jax(rj, device='cpu')


def _assert_grads(got, want):
    for name, g, w in zip(('vertices', 'textures'), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _grads(method, aa, v, f, tx, weights):
    """(port grads, JAX grads) of sum_k sum(out_k * weights_k) w.r.t.
    vertices (and textures when given) through ``method``."""
    rj, rt = _renderers(aa)

    def outs(r, vv, ff, tt):
        out = getattr(r, method)(*((vv, ff) if tx is None else (vv, ff, tt)))
        if isinstance(out, dict):
            return [out['rgb'], out['alpha'], out['depth']]
        return [out]

    def loss_j(vv, tt):
        return sum(jnp.sum(o * w) for o, w in
                   zip(outs(rj, vv, f, tt), weights))

    argnums = (0,) if tx is None else (0, 1)
    want = jax.grad(loss_j, argnums=argnums)(
        jnp.asarray(v), None if tx is None else jnp.asarray(tx))
    vt, ft, tt = nt.arrays_from_numpy(v, f, tx, device='cpu')
    vt.requires_grad_()
    if tt is not None:
        tt.requires_grad_()
    loss = sum((o * torch.as_tensor(w)).sum() for o, w in
               zip(outs(rt, vt, ft, tt), weights))
    loss.backward()
    got = [vt.grad.numpy()] + ([] if tt is None else [tt.grad.numpy()])
    return got, want


def _assert_grads_of(*args):
    """``_assert_grads`` of ``_grads(*args)``; on a mismatch both sides run
    again and the message says which one moved (ROADMAP Queue 3: one
    failure in 20 runs of the [2-False] case, not reproduced since)."""
    got, want = _grads(*args)
    try:
        _assert_grads(got, want)
    except AssertionError as e:
        again = _grads(*args)
        moved = [side for side, first, second in (('port', got, again[0]),
                                                  ('JAX', want, again[1]))
                 if not all(np.array_equal(np.asarray(a), np.asarray(b))
                            for a, b in zip(first, second))]
        raise AssertionError(
            f'{e}\nrun again: ' + (' and '.join(moved) + ' moved' if moved
                                    else 'both sides repeat their gradients '
                                    'bit for bit')) from None


def _weights(rng, shapes):
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize('aa', [False, True])
@pytest.mark.parametrize('ts', [2, 4, 5])
def test_render_grads_match_jax(batch, aa, ts):
    v, f = batch
    rng = np.random.RandomState(ts)
    tx = rng.uniform(0.1, 1, (2, f.shape[1], ts, ts, ts, 3)).astype(
        np.float32)
    _assert_grads_of('render', aa, v, f, tx,
                     _weights(rng, [(2, 3, IS, IS)]))


@pytest.mark.parametrize('aa', [False, True])
@pytest.mark.parametrize('method', ['render_silhouettes', 'render_depth'])
def test_silhouette_and_depth_grads_match_jax(batch, aa, method):
    v, f = batch
    rng = np.random.RandomState(7)
    _assert_grads_of(method, aa, v, f, None,
                     _weights(rng, [(2, IS, IS)]))


@pytest.mark.parametrize('aa', [False, True])
def test_render_rgbad_grads_match_jax(batch, aa):
    v, f = batch
    rng = np.random.RandomState(9)
    tx = rng.uniform(0.1, 1, (2, f.shape[1], 2, 2, 2, 3)).astype(np.float32)
    w = _weights(rng, [(2, 3, IS, IS), (2, IS, IS), (2, IS, IS)])
    w[2] *= 0.01
    _assert_grads_of('render_rgbad', aa, v, f, tx, w)


def test_rasterize_class_grads_match_rgbad():
    """The Rasterize compat class (raster space, no AA) and rasterize_rgbad
    without AA run the same backward: with the cotangents flipped into
    raster space, the face, texture and background gradients are bitwise
    equal."""
    rng = np.random.RandomState(3)
    fc = rng.uniform(-0.9, 0.9, (2, 20, 3, 3)).astype(np.float32)
    fc[..., 2] = 1.0 + 0.3 * fc[..., 2]
    tx = rng.uniform(0, 1, (2, 20, 2, 2, 2, 3)).astype(np.float32)
    w_rgb, w_a, w_d = _weights(rng, [(2, 3, 32, 32), (2, 32, 32),
                                     (2, 32, 32)])
    bg = [0.1, 0.2, 0.3]

    def leaves():
        return (torch.tensor(fc, requires_grad=True),
                torch.tensor(tx, requires_grad=True),
                torch.tensor(bg, requires_grad=True))

    f1, t1, b1 = leaves()
    ras = nt.Rasterize(32, 0.1, 100, 1e-3, b1, return_rgb=True,
                       return_alpha=True, return_depth=True)
    rgb, alpha, depth = ras(f1, t1)
    t = torch.as_tensor
    (torch.sum(rgb * torch.flip(t(w_rgb), dims=[2]).permute(0, 2, 3, 1))
     + torch.sum(alpha * torch.flip(t(w_a), dims=[1]))
     + torch.sum(depth * torch.flip(t(w_d), dims=[1]))).backward()

    f2, t2, b2 = leaves()
    out = nt.rasterize_rgbad(f2, t2, 32, False, 0.1, 100, 1e-3, b2)
    (torch.sum(out['rgb'] * t(w_rgb)) + torch.sum(out['alpha'] * t(w_a))
     + torch.sum(out['depth'] * t(w_d))).backward()
    for a, b in ((f1, f2), (t1, t2), (b1, b2)):
        np.testing.assert_array_equal(a.grad.numpy(), b.grad.numpy())
        assert a.grad.abs().max() > 0


def _approx_scene():
    """tests/test_approx_aa.py's scene: the teapot at azimuth 45 with
    fill_back, random ts-2 textures from seed 0."""
    v, f = nt.load_obj(TEAPOT)
    r = nt.Renderer()
    r.eye = nt.get_points_from_angles(2.732, 30.0, 45.0)
    rng = np.random.RandomState(0)
    tx = rng.uniform(0, 1, (1, f.shape[0], 2, 2, 2, 3)).astype(np.float32)
    ft = torch.as_tensor(f[None].astype(np.int64))
    fc = nt.vertices_to_faces(r._transform(torch.as_tensor(v[None])),
                              r._fill_back_faces(ft))
    return fc, torch.as_tensor(np.concatenate([tx, tx], 1))


def test_approx_aa_values_match_exact_aa():
    """tests/test_approx_aa.py:37: values bit for bit those of True, also
    with a gradient asked for."""
    fc, tx = _approx_scene()
    bg = (0.2, 0.3, 0.4)
    exact = nt.rasterize_rgbad(fc, tx, IS, True, background_color=bg)
    approx = nt.rasterize_rgbad(fc, tx, IS, 'approx', background_color=bg)
    fg = fc.clone().requires_grad_()
    approx_g = nt.rasterize_rgbad(fg, tx, IS, 'approx', background_color=bg)
    for k in ('rgb', 'alpha', 'depth'):
        np.testing.assert_array_equal(exact[k].numpy(), approx[k].numpy())
        np.testing.assert_array_equal(exact[k].numpy(),
                                      approx_g[k].detach().numpy())
    a = exact['alpha'].numpy()
    assert a.max() == 1.0 and ((a > 0) & (a < 1)).sum() > 10


def test_approx_aa_grads_match_1x_render():
    """tests/test_approx_aa.py:53: gradients bit for bit those of the
    un-antialiased render, and within the render tests' tolerance of the
    JAX package's 'approx' gradients."""
    fc, tx = _approx_scene()

    def grads(mode):
        a = fc.clone().requires_grad_()
        t = tx.clone().requires_grad_()
        out = nt.rasterize_rgbad(a, t, IS, mode)
        (out['rgb'].sum() * 0.3 + out['alpha'].sum()
         + out['depth'].sum() * 0.01).backward()
        return a.grad.numpy(), t.grad.numpy()

    def loss_j(a, t):
        out = nr.rasterize_rgbad(a, t, IS, 'approx')
        return (jnp.sum(out['rgb'] * 0.3) + jnp.sum(out['alpha'])
                + jnp.sum(out['depth'] * 0.01))

    ga_f, gt_f = grads(False)
    ga_a, gt_a = grads('approx')
    np.testing.assert_array_equal(ga_f, ga_a)
    np.testing.assert_array_equal(gt_f, gt_a)
    _assert_grads((ga_a, gt_a), jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(fc.numpy()), jnp.asarray(tx.numpy())))


def _adam_pair(grads, scales, steps, alpha=0.1):
    """Run the port's Adam and nr.adam on the same parameters and grads;
    returns (port params, port state, JAX params, JAX state)."""
    params = {k: np.linspace(1.0, 2.0, g.size).astype(np.float32)
              for k, g in grads.items()}
    init, update = nr.adam(alpha=alpha, lr_scales=scales)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    state = init(pj)
    pt = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = nt.Adam([dict(params=[pt[k]], lr_scale=scales[k]) for k in pt],
                  alpha=alpha)
    for _ in range(steps):
        upd, state = update({k: jnp.asarray(g) for k, g in grads.items()},
                            state)
        pj = {k: pj[k] + upd[k] for k in pj}
        for k in pt:
            pt[k].grad = torch.tensor(grads[k])
        opt.step()
    return pt, opt, pj, state


def test_adam_matches_jax():
    """Five steps: the element-wise zero-grad skip (m, v and the parameter
    untouched where grad == 0) and a per-parameter LR scale."""
    grads = dict(a=np.array([0.5, 0.0, -0.5, 3.0], np.float32),
                 b=np.array([1.0, -2.0, 0.0], np.float32))
    pt, opt, pj, state = _adam_pair(grads, dict(a=1.0, b=0.1), steps=5)
    for k in pt:
        np.testing.assert_allclose(pt[k].detach().numpy(), pj[k],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        st = opt.state[pt[k]]
        np.testing.assert_allclose(st['m'].numpy(), state.m[k], rtol=1e-6)
        np.testing.assert_allclose(st['v'].numpy(), state.v[k], rtol=1e-6)
    start = np.linspace(1.0, 2.0, 4).astype(np.float32)
    assert pt['a'].detach().numpy()[1] == start[1]
    assert opt.state[pt['a']]['m'][1] == 0
    assert opt.state[pt['a']]['v'][1] == 0
    assert pt['a'].detach().numpy()[0] < start[0]


def test_adam_zero_lr_scale_freezes_parameter():
    """A scale of 0 skips the parameter entirely, m and v included
    (optimizers.py:17-18), as nr.adam does."""
    grads = dict(a=np.array([0.5, -1.0], np.float32),
                 b=np.array([0.5, -1.0], np.float32))
    pt, opt, pj, state = _adam_pair(grads, dict(a=1.0, b=0.0), steps=5)
    np.testing.assert_array_equal(pt['b'].detach().numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(np.asarray(pj['b']), [1.0, 2.0])
    assert opt.state[pt['b']]['m'].abs().max() == 0
    np.testing.assert_allclose(pt['a'].detach().numpy(), pj['a'], rtol=1e-6)


def test_mesh_from_jax_get_batch():
    mj = nr.Mesh.from_obj(TEAPOT, texture_size=2, seed=5).set_lr(0.5, 2.0)
    mt = nt.mesh_from_jax(mj, device='cpu')
    assert mt.num_vertices == 1292 and mt.num_faces == 2464
    assert mt.texture_size == 2
    v, f, t = mt.get_batch(3)
    vj, fj, tj = mj.get_batch(3)
    np.testing.assert_array_equal(v.detach().numpy(), vj)
    np.testing.assert_array_equal(f.numpy(), fj)
    np.testing.assert_allclose(t.detach().numpy(), tj, rtol=1e-6, atol=1e-7)
    # from_obj draws the same textures from the same seed
    np.testing.assert_array_equal(
        nt.Mesh.from_obj(TEAPOT, texture_size=2, seed=5,
                         device='cpu').textures.detach()
        .numpy(), np.asarray(mj.textures))
    groups = mt.lr_scales()
    assert [g['lr_scale'] for g in groups] == [0.5, 2.0]
    assert groups[0]['params'][0] is mt.vertices
    # spatial order is ported: the JAX package's permutation exactly
    ordered = nt.Mesh(TEAPOT, spatial_order=True, device='cpu')
    np.testing.assert_array_equal(
        ordered.face_order,
        nr.Mesh(TEAPOT, texture_size=4, spatial_order=True).face_order)


def test_three_adam_steps_match_jax():
    """Three Adam steps of an L2 fit of the teapot (ts 2 textures, seed 3)
    to a random target, port against JAX."""
    mj = nr.Mesh.from_obj(TEAPOT, texture_size=2, seed=3)
    mt = nt.mesh_from_jax(mj, device='cpu')
    rj, rt = _renderers(False, nr.get_points_from_angles(2.732, 30.0, 45.0))
    target = np.random.RandomState(0).uniform(0, 1, (2, 3, IS, IS)).astype(
        np.float32)

    def loss_j(m):
        v, f, t = m.get_batch(2)
        return jnp.sum(jnp.square(rj.render(v, f, t) - target))

    init, update = nr.adam(alpha=0.01, lr_scales=mj.lr_scales())
    state = init(mj)
    opt = nt.Adam(mt.lr_scales(), alpha=0.01)
    for _ in range(3):
        lj, g = jax.value_and_grad(loss_j)(mj)
        upd, state = update(g, state)
        mj = jax.tree.map(lambda p, u: p + u, mj, upd)
        opt.zero_grad()
        v, f, t = mt.get_batch(2)
        lt = ((rt.render(v, f, t) - torch.as_tensor(target)) ** 2).sum()
        lt.backward()
        opt.step()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(mt.vertices.detach().numpy(),
                               np.asarray(mj.vertices), rtol=0, atol=2e-4)
    np.testing.assert_allclose(mt.textures.detach().numpy(),
                               np.asarray(mj.textures), rtol=0, atol=2e-4)
    assert np.abs(mt.vertices.detach().numpy()
                  - np.asarray(nr.Mesh.from_obj(TEAPOT).vertices)).max() > 0
