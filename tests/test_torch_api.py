"""The rest of the port's flat API and its deterministic scatters, on the
CPU.

* ``neural_renderer_torch.__all__`` holds every name of the JAX package's;
* ``use_unsafe_rasterizer`` is a no-op that warns, as in the JAX package;
* the functional ``adam`` equals the ``Adam`` class and the JAX package's
  ``adam`` over 3 steps within 1e-7;
* the plain segmented row sum (``ops/segments.py``, the plain version of
  ``csrc/segment_sum.cu``) equals ``index_add_`` within 1e-6 of the column
  max, and ``vertices_to_faces``' backward equals autograd's fancy-index
  gradient bit for bit (with ``fill_back``, the doubled list's); its sort
  is kept per face tensor, and faces made under ``torch.inference_mode``
  render;
* the out-sweep's round planning (``backward_cuda.outsweep_plan``) fits
  every line length up to 8192 in 227 KB of shared memory.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
from neural_renderer_torch.ops import segments
from neural_renderer_torch.ops import vertices_to_faces as v2f
from neural_renderer_torch.rasterize import api as nt_api
from neural_renderer_torch.rasterize import backward_cuda

# the H100's opt-in shared memory per block, less the out-sweep's static
# shared memory (272 bytes in the ptxas report)
SMEM = 227 * 1024 - 272


def test_flat_api_covers_jax():
    missing = set(nr.__all__) - set(nt.__all__)
    assert not missing, sorted(missing)
    for name in nt.__all__:
        assert hasattr(nt, name), name


def test_use_unsafe_rasterizer_is_a_noop():
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        nt.use_unsafe_rasterizer(False)
    assert nt_api.USE_UNSAFE_IMPLEMENTATION is False
    with pytest.warns(UserWarning, match='no-op'):
        nt.use_unsafe_rasterizer(True)
    assert nt_api.USE_UNSAFE_IMPLEMENTATION is True
    nt.use_unsafe_rasterizer(False)


def test_adam_functional_equals_class_and_jax():
    rng = np.random.RandomState(5)
    shapes = dict(a=(7, 3), b=(11,))
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    scales = dict(a=1.0, b=0.5)
    grads = [{k: np.where(rng.uniform(size=s) < 0.3, 0.0,
                          rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    init, update = nt.adam(alpha=0.1, lr_scales=scales)
    pf = {k: torch.tensor(v) for k, v in params.items()}
    state = init(pf)
    pc = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = nt.Adam([dict(params=[pc[k]], lr_scale=scales[k]) for k in pc],
                  alpha=0.1)
    jinit, jupdate = nr.adam(alpha=0.1, lr_scales=scales)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jinit(pj)
    for g in grads:
        upd, state = update({k: torch.tensor(v) for k, v in g.items()},
                            state)
        pf = {k: pf[k] + upd[k] for k in pf}
        for k in pc:
            pc[k].grad = torch.tensor(g[k])
        opt.step()
        jupd, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                               jstate)
        pj = {k: pj[k] + jupd[k] for k in pj}
    assert state['count'] == 3
    for k in params:
        np.testing.assert_allclose(pf[k].numpy(), pc[k].detach().numpy(),
                                   atol=1e-7, rtol=0)
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(pj[k]),
                                   atol=1e-7, rtol=0)
        np.testing.assert_allclose(state['m'][k].numpy(),
                                   np.asarray(jstate.m[k]), atol=1e-7, rtol=0)
        assert not np.array_equal(pf[k].numpy(), params[k])


@pytest.mark.parametrize('n,nseg,C', [(1000, 50, 3), (5000, 997, 1),
                                      (300, 400, 7)])
def test_segment_sum_plain_equals_index_add(n, nseg, C):
    rng = np.random.RandomState(n)
    rows = torch.tensor(rng.normal(size=(n, C)).astype(np.float32))
    ids = torch.tensor(rng.randint(0, nseg + 5, n))   # some past the end
    perm, offsets = segments.sort_segments(ids, nseg)
    assert offsets.shape == (nseg + 1,) and int(offsets[0]) == 0
    got = segments.segment_sum(rows, perm, offsets)
    want = torch.zeros(nseg + 5, C).index_add_(0, ids, rows)[:nseg]
    scale = want.abs().amax(0, keepdim=True).clamp_min(1e-30)
    assert float(((got - want).abs() / scale).max()) <= 1e-6
    # the rows of ids past the last segment are never summed
    assert int(offsets[-1]) == int((ids < nseg).sum())


def _fold(rows, ids, nseg):
    """Each segment's rows added in row order, one float32 add at a time."""
    out = np.zeros((nseg, rows.shape[1]), np.float32)
    for i in range(rows.shape[0]):
        if ids[i] < nseg:
            out[ids[i]] = out[ids[i]] + rows[i]
    return out


@pytest.mark.parametrize('case', ['thousands of rows', 'empty segments',
                                  'ids at and past nseg', 'strided rows'])
def test_segment_sum_adds_rows_in_order(case):
    """Bit for bit the rows of each segment added in ascending row order:
    one segment of 3000 rows among short ones, most segments empty, ids at
    and past ``nseg`` never read, a rows tensor that is not contiguous."""
    rng = np.random.RandomState(len(case))
    nseg, n, C = 40, 600, 3
    ids = rng.randint(0, nseg, n)
    if case == 'thousands of rows':
        ids = np.concatenate([ids, np.full(3000, 17)])
        rng.shuffle(ids)
    elif case == 'empty segments':
        nseg = 5000
    elif case == 'ids at and past nseg':
        ids[::3] = nseg + rng.randint(0, 3, ids[::3].shape)
    rows = rng.normal(size=(ids.shape[0], C)).astype(np.float32)
    rows_t = torch.tensor(rows)
    if case == 'strided rows':
        wide = torch.tensor(rng.normal(size=(ids.shape[0], 2 * C)).astype(
            np.float32))
        rows_t = wide[:, ::2]
        rows = rows_t.numpy().copy()
        assert not rows_t.is_contiguous()
    perm, offsets = segments.sort_segments(torch.tensor(ids), nseg)
    got = segments.segment_sum(rows_t, perm, offsets)
    want = _fold(rows, ids, nseg)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    if case == 'empty segments':
        assert int((offsets[1:] == offsets[:-1]).sum()) > 4000


def test_segment_sum_checks_inputs():
    rows = torch.zeros(4, 3)
    perm, offsets = segments.sort_segments(torch.tensor([0, 1, 1, 0]), 2)
    with pytest.raises(ValueError):
        segments.segment_sum(rows.double(), perm, offsets)
    with pytest.raises(ValueError):
        segments.segment_sum(rows, perm[:3], offsets)


def test_vertices_to_faces_backward_equals_fancy_index():
    rng = np.random.RandomState(2)
    bs, nv, nf = 3, 40, 70
    v = torch.tensor(rng.normal(size=(bs, nv, 3)).astype(np.float32),
                     requires_grad=True)
    f = torch.tensor(rng.randint(0, nv, (bs, nf, 3)))
    g = torch.tensor(rng.normal(size=(bs, nf, 3, 3)).astype(np.float32))
    out = nt.vertices_to_faces(v, f)
    (out * g).sum().backward()
    v2 = v.detach().clone().requires_grad_()
    flat = (f + (torch.arange(bs) * nv)[:, None, None]).reshape(-1)
    want = v2.reshape(-1, 3)[flat].reshape(bs, nf, 3, 3)
    (want * g).sum().backward()
    assert torch.equal(out, want)
    assert torch.equal(v.grad, v2.grad)


def test_vertices_to_faces_fill_back_equals_doubled_list():
    """``fill_back=True`` gathers for the face list and its back-to-front
    copy, as the Renderer draws it: output and gradient bit-equal to the
    gather of the doubled list."""
    rng = np.random.RandomState(3)
    bs, nv, nf = 2, 30, 50
    v = torch.tensor(rng.normal(size=(bs, nv, 3)).astype(np.float32),
                     requires_grad=True)
    f = torch.tensor(rng.randint(0, nv, (bs, nf, 3)).astype(np.int32))
    g = torch.tensor(rng.normal(size=(bs, 2 * nf, 3, 3)).astype(np.float32))
    out = nt.vertices_to_faces(v, f, fill_back=True)
    (out * g).sum().backward()
    v2 = v.detach().clone().requires_grad_()
    want = nt.vertices_to_faces(
        v2, nt.Renderer._fill_back_faces(f.long()))
    (want * g).sum().backward()
    assert out.shape == (bs, 2 * nf, 3, 3)
    assert torch.equal(out, want)
    assert torch.equal(v.grad, v2.grad)


def test_vertices_to_faces_keeps_sort_per_face_tensor():
    """The vertex scatter's sort is made once per caller face tensor (a
    Mesh's broadcast view hits the same entry), made anew after an
    in-place write, and never kept for an inference tensor."""
    nv = 20
    f = torch.tensor(np.random.RandomState(4).randint(0, nv, (1, 30, 3)))
    flat = v2f._flat_index(f, nv)
    first = v2f._sort(f, flat, nv, None)
    assert v2f._sort(f, flat, nv, None) is first
    assert v2f._sort(f.expand(1, 30, 3), flat, nv, None) is first
    f[0, 0, 0] = (int(f[0, 0, 0]) + 1) % nv
    flat = v2f._flat_index(f, nv)
    again = v2f._sort(f, flat, nv, None)
    assert again is not first
    assert torch.equal(again[0], segments.sort_segments(flat, nv)[0])
    with torch.inference_mode():
        fi = f.clone()
    kept = len(v2f._SORTS)
    perm, offsets = v2f._sort(fi, v2f._flat_index(fi, nv), nv, None)
    assert torch.equal(perm, again[0]) and torch.equal(offsets, again[1])
    assert len(v2f._SORTS) == kept


def test_render_with_inference_faces():
    """Faces made under ``torch.inference_mode`` (which carry no version
    counter) render as the same faces made outside it, inside and outside
    inference mode, and the vertex gradient flows."""
    rng = np.random.RandomState(6)
    v = rng.uniform(-0.5, 0.5, (1, 12, 3)).astype(np.float32)
    f = rng.randint(0, 12, (1, 16, 3))
    r = nt.Renderer()
    r.image_size = 32
    r.anti_aliasing = False
    vt = torch.tensor(v, requires_grad=True)
    want = r.render_silhouettes(vt, torch.tensor(f))
    with torch.inference_mode():
        fi = torch.tensor(f)
        got_inside = r.render_silhouettes(torch.tensor(v), fi)
    got = r.render_silhouettes(vt, fi)
    assert torch.equal(got_inside, want.detach())
    assert torch.equal(got.detach(), want.detach())
    got.sum().backward()
    assert vt.grad is not None and bool(torch.isfinite(vt.grad).all())


@pytest.mark.parametrize('rgb,alpha', [(True, True), (True, False),
                                       (False, True)])
def test_outsweep_plan_fits_any_line(rgb, alpha):
    for is_ in (1, 7, 64, 512, 1400, 2048, 2800, 4096, 6000, 8192):
        plan = backward_cuda.outsweep_plan(is_, rgb, alpha, SMEM)
        assert plan['smem'] <= SMEM, (is_, plan)
        assert 3 <= plan['cap'] <= 3 * is_
        if is_ <= 512:
            # the main path's lines are one round with staged planes
            assert plan['staged'] and plan['cap'] == 3 * is_, (is_, plan)
    forced = backward_cuda.outsweep_plan(512, rgb, alpha, SMEM, cap=5,
                                         staged=False)
    assert forced == dict(staged=False, cap=5, smem=4 + 5 * 20)
    with pytest.raises(ValueError):
        backward_cuda.outsweep_plan(512, rgb, alpha, SMEM, cap=2)
