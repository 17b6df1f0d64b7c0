"""Batch and face-axis parallelism of the port (``neural_renderer_torch.
parallel``) in spawned gloo ranks on the CPU.

Each fixture spawns its ranks once (``torch.multiprocessing``, gloo, a
``file://`` rendezvous under ``tmp_path``, joined with a 60 s timeout so a
hang fails instead of stalling the suite); the ranks save what they
rendered and their gradients, and the tests hold them against one process:

* batch-sharded renders (all four modes): each rank's images equal the
  one-process render's slice bit for bit;
* face-sharded ``render_rgbad`` and ``render_silhouettes`` (2 and 4 ranks;
  ts 2, fused in the forward kernel, and ts 5, shaded after it): every
  rank's images equal the one-process render of the shard-order face list
  bit for bit, and the JAX package's eager render within atol 1e-5 with
  equal coverage (as test_torch_renderer.py holds the port);
* face-sharded gradients under the JAX package's contract
  (tests/test_face_parallel.py): textures equal, faces within rtol 5e-4
  with under 0.5% of elements differing, background within rtol 1e-6; the
  vertices (summed over the ranks, so last-bit differences are many)
  within rtol 5e-4;
* the 2 x 2 composition of a batch group and a face group;
* the data-parallel step: the loss falls over 3 steps and the averaged
  gradients equal one process's on the whole batch within 1e-5 of their
  max;
* ``misc/torch_multiview.py`` in 2 ranks started as ``torchrun`` starts
  them (the group named by the environment only, made and destroyed by the
  script): the ranks' slices, joined, equal one process's
  ``render_rgbad`` of all the views bit for bit.

The ranks import neither JAX nor the JAX package: only the parent does.
The ranks and the one-process references each run one CPU thread.  A
face-sharded image that differs names its first differing pixel and the
rank whose face wins it.
"""

import contextlib
import importlib.util
import io
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import neural_renderer_torch as nt
from neural_renderer_torch import parallel
from neural_renderer_torch.rasterize import forward_dense
from neural_renderer_torch.rasterize.config import RasterizeSettings

TEAPOT = os.path.join(os.path.dirname(__file__), 'data', 'teapot.obj')
MULTIVIEW = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'misc', 'torch_multiview.py')
BS = 4
IMAGE = 32
JOIN_TIMEOUT = 60.0
# the ranks and the one-process references run one CPU thread each, so both
# sides run the same CPU kernels on the same splits of their work
THREADS = 1


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(saved)


def _entry(rank, fn, world, path, args, port):
    torch.set_num_threads(THREADS)
    if port is None:
        dist.init_process_group('gloo',
                                init_method=f'file://{path}/rendezvous',
                                world_size=world, rank=rank)
    else:
        # as torchrun starts a rank: the environment names the group, and
        # ``fn`` makes it
        os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                          WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(rank))
    try:
        torch.save(fn(rank, world, *args), f'{path}/rank{rank}.pt')
    finally:
        if port is None:
            dist.destroy_process_group()


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _spawn(fn, world, path, *args, port=None):
    """Run ``fn(rank, world, *args)`` in ``world`` gloo ranks; returns
    each rank's result.  With a ``port`` the ranks get torchrun's
    environment on it instead of a group."""
    os.makedirs(path, exist_ok=True)
    ctx = mp.spawn(_entry, args=(fn, world, path, args, port), nprocs=world,
                   join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f'{fn.__name__} in {world} ranks did not finish in '
                        f'{JOIN_TIMEOUT} s')
    return [torch.load(f'{path}/rank{r}.pt') for r in range(world)]


def _scene(ts):
    """The teapot batch: BS rows jittered from a numpy seed, textures of
    cube size ``ts``, output seeds for the loss."""
    v, f = nt.load_obj(TEAPOT)
    rng = np.random.RandomState(ts)
    vs = (v[None] + rng.uniform(-0.01, 0.01, (BS,) + v.shape)).astype(
        np.float32)
    fs = np.tile(f[None], (BS, 1, 1)).astype(np.int64)
    tx = rng.uniform(0, 1, (BS, f.shape[0], ts, ts, ts, 3)).astype(
        np.float32)
    seeds = rng.uniform(-1, 1, (BS, 5, IMAGE, IMAGE)).astype(np.float32)
    return vs, fs, tx, seeds


def _renderer(fill_back=True):
    r = nt.Renderer()
    r.image_size = IMAGE
    r.fill_back = fill_back
    return r


def _loss(o, seeds):
    return ((o['rgb'] * seeds[:, :3]).sum() + (o['alpha'] * seeds[:, 3]).sum()
            + (o['depth'] * seeds[:, 4]).sum())


def _face_coords(vs, fs):
    r = _renderer()
    return r._transform_faces(nt.vertices_to_faces(vs, fs)).detach()


def _face_worker(rank, world, ts_list):
    g = dist.group.WORLD
    res = {}
    for ts in ts_list:
        vs, fs, tx, seeds = (torch.tensor(a) for a in _scene(ts))
        fl, tl = parallel.shard_faces(g, fs, tx)
        tl = tl.clone().requires_grad_()
        v = vs.clone().requires_grad_()
        o = parallel.make_face_sharded_render(_renderer(), g, 'rgbad')(
            v, fl, tl)
        _loss(o, seeds).backward()
        sil = parallel.make_face_sharded_render(
            _renderer(), g, 'silhouettes')(vs, fl)
        # the rasterizer alone: face coordinate, texture and background
        # gradients of this rank's slice
        fc = _face_coords(vs, fs)
        part = parallel._rank_slice(g, fc.shape[1])
        fcl = fc[:, part].clone().requires_grad_()
        txl = tx[:, part].clone().requires_grad_()
        bg = torch.tensor([0.2, 0.3, 0.4], requires_grad=True)
        img = nt.rasterize(fcl, txl, IMAGE, False, background_color=bg,
                           face_group=g)
        (img * seeds[:, :3]).sum().backward()
        res[ts] = dict(rgb=o['rgb'].detach(), alpha=o['alpha'].detach(),
                       depth=o['depth'].detach(), sil=sil, fl=fl,
                       tl=tl.detach(), g_vertices=v.grad, g_tex=tl.grad,
                       img=img.detach(), g_fc=fcl.grad, g_txl=txl.grad,
                       g_bg=bg.grad)
    vs, fs, tx, _ = (torch.tensor(a) for a in _scene(2))
    res['batch'] = {mode: parallel.sharded_render(
        _renderer(), g, vs, fs, tx if mode in ('rgb', 'rgbad') else None,
        mode) for mode in parallel.MODES}
    return res


def _grid_worker(rank, world):
    # ranks (b, f) = divmod(rank, 2): face groups {0, 1}, {2, 3}; batch
    # groups {0, 2}, {1, 3}; every rank creates every group in one order
    face_groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    batch_groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    b, f = divmod(rank, 2)
    vs, fs, tx, _ = (torch.tensor(a) for a in _scene(2))
    fl, tl = parallel.shard_faces(face_groups[b], fs, tx)
    o = parallel.make_face_sharded_render(
        _renderer(), face_groups[b], 'rgbad', batch_group=batch_groups[f])(
            vs, fl, tl)
    return dict(o, fl=fl, tl=tl)


def _dp_problem():
    v, f = nt.load_obj(TEAPOT)
    scales = np.array([0.9, 1.0, 1.1, 1.2], np.float32)
    r = _renderer()
    with torch.no_grad():
        target = r.render_silhouettes(
            torch.tensor(v[None] * scales[:, None, None]),
            torch.tensor(np.tile(f[None], (BS, 1, 1))))
    faces = torch.tensor(f)

    def loss_fn(params, batch):
        n = batch.shape[0]
        img = r.render_silhouettes(
            params['vertices'][None].expand(n, -1, -1),
            faces[None].expand(n, -1, -1))
        return ((img - batch) ** 2).sum(dim=(1, 2)).mean()

    return dict(vertices=torch.tensor(v)), target, loss_fn


def _dp_worker(rank, world):
    g = dist.group.WORLD
    params, target, loss_fn = _dp_problem()
    init_fn, update_fn = nt.adam(alpha=0.01)
    state = init_fn(params)
    step = parallel.make_data_parallel_train_step(loss_fn, update_fn, g)
    batch = parallel.shard_batch(g, target)
    losses, ms = [], []
    for _ in range(3):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        ms.append(state['m']['vertices'].clone())
    return dict(losses=losses, m=ms, vertices=params['vertices'])


@pytest.fixture(scope='module', params=[2, 4], ids=['2ranks', '4ranks'])
def face_runs(request, tmp_path_factory):
    world = request.param
    ts_list = (2, 5) if world == 2 else (2,)
    path = str(tmp_path_factory.mktemp(f'face{world}'))
    return world, ts_list, _spawn(_face_worker, world, path, ts_list)


def _shard_order(results, key_f, key_t):
    """The one-process face list (and textures) the face-sharded render
    equals: each rank's slice followed by its fill_back copy, in rank
    order."""
    faces = torch.cat([torch.cat([r[key_f], r[key_f].flip(2)], 1)
                       for r in results], 1)
    tex = torch.cat([torch.cat([r[key_t], r[key_t].permute(0, 1, 4, 3, 2, 5)],
                               1) for r in results], 1)
    return faces, tex


def _one_process(ts, faces, tex):
    vs, _, _, seeds = (torch.tensor(a) for a in _scene(ts))
    v = vs.clone().requires_grad_()
    tex = tex.clone().requires_grad_()
    r = _renderer(fill_back=False)
    o = r.render_rgbad(v, faces, tex)
    _loss(o, seeds).backward()
    sil = r.render_silhouettes(vs, faces)
    return dict(rgb=o['rgb'].detach(), alpha=o['alpha'].detach(),
                depth=o['depth'].detach(), sil=sil.detach(),
                g_vertices=v.grad, g_tex=tex.grad)


def _assert_grad_contract(got, want, what):
    """JAX's face-parallel contract (tests/test_face_parallel.py:169-176)."""
    a, b = want.numpy(), got.numpy()
    assert (a != b).mean() < 0.005, f'{what} diverge structurally'
    np.testing.assert_allclose(b, a, rtol=5e-4, atol=5e-4 * np.abs(a).max(),
                               err_msg=what)
    assert float(np.abs(a).max()) > 0


def _mismatch(what, got, want, vs, faces, nfl):
    """Where a face-sharded image differs from the one-process render: the
    first differing output pixel, both values, and the raster pixels under
    it (2x2 with anti-aliasing, the image flipped vertically) with the
    one-process winner of each and the rank that holds it."""
    at = tuple(int(i) for i in (got != want).nonzero()[0])
    b, y, x = at[0], at[-2], at[-1]
    fim, _ = forward_dense.forward_face_index_map(
        RasterizeSettings(image_size=2 * IMAGE),
        _face_coords(vs[b:b + 1], faces[b:b + 1]))
    rows = [2 * IMAGE - 1 - 2 * y - d for d in (0, 1)]
    ids = fim[0, rows][:, [2 * x, 2 * x + 1]].flatten().tolist()
    ranks = [i // (2 * nfl) if i >= 0 else None for i in ids]
    return (f'{what}: {int((got != want).sum())} values differ; first at '
            f'{at}: {float(got[at])!r} against {float(want[at])!r}; raster '
            f'winners {ids} held by ranks {ranks}')


def test_face_sharded_render_equals_one_process(face_runs):
    world, ts_list, results = face_runs
    for ts in ts_list:
        rs = [r[ts] for r in results]
        faces, tex = _shard_order(rs, 'fl', 'tl')
        want = _one_process(ts, faces, tex)
        vs = torch.tensor(_scene(ts)[0])
        for rank, r in enumerate(rs):
            for k in ('rgb', 'alpha', 'depth', 'sil'):
                if not torch.equal(r[k], want[k]):
                    pytest.fail(_mismatch(
                        f'{world} ranks, ts {ts}, rank {rank}, {k}', r[k],
                        want[k], vs, faces, rs[0]['fl'].shape[1]))
        assert float(want['sil'].max()) == 1.0


def test_face_sharded_gradients(face_runs):
    world, ts_list, results = face_runs
    for ts in ts_list:
        rs = [r[ts] for r in results]
        faces, tex = _shard_order(rs, 'fl', 'tl')
        want = _one_process(ts, faces, tex)
        nfl = rs[0]['fl'].shape[1]
        for k, r in enumerate(rs):
            # the rank's textures and their fill_back copy's gradient
            part = want['g_tex'][:, 2 * nfl * k:2 * nfl * (k + 1)]
            g = part[:, :nfl] + part[:, nfl:].permute(0, 1, 4, 3, 2, 5)
            assert torch.equal(r['g_tex'], g), (world, ts, k)
            # the ranks' partial vertex sums are added over the group:
            # last-bit differences in many elements, within the tolerance
            a = want['g_vertices']
            torch.testing.assert_close(r['g_vertices'], a, rtol=5e-4,
                                       atol=5e-4 * float(a.abs().max()))


def test_face_sharded_rasterize_gradients(face_runs):
    """nt.rasterize(face_group=...) on face coordinates: the ranks' face
    gradients are slices of the one-process gradient."""
    world, ts_list, results = face_runs
    for ts in ts_list:
        vs, fs, tx, seeds = (torch.tensor(a) for a in _scene(ts))
        fc = _face_coords(vs, fs).requires_grad_()
        tx = tx.clone().requires_grad_()
        bg = torch.tensor([0.2, 0.3, 0.4], requires_grad=True)
        img = nt.rasterize(fc, tx, IMAGE, False, background_color=bg)
        (img * seeds[:, :3]).sum().backward()
        nfl = fc.shape[1] // world
        g_fc = torch.cat([r[ts]['g_fc'] for r in results], 1)
        g_tx = torch.cat([r[ts]['g_txl'] for r in results], 1)
        for r in results:
            assert torch.equal(r[ts]['img'], img.detach())
            np.testing.assert_allclose(r[ts]['g_bg'].numpy(),
                                       bg.grad.numpy(), rtol=1e-6)
        assert torch.equal(g_tx, tx.grad)
        assert nfl * world == fc.shape[1]
        _assert_grad_contract(g_fc, fc.grad, f'grad faces {world} ts {ts}')


def test_face_sharded_render_equals_jax(face_runs):
    """The face-sharded images against the JAX package's eager
    single-device render of the shard-order list."""
    import neural_renderer_tpu as nr
    world, ts_list, results = face_runs
    rs = [r[ts_list[0]] for r in results]
    faces, tex = _shard_order(rs, 'fl', 'tl')
    vs = _scene(ts_list[0])[0]
    rj = nr.Renderer()
    rj.image_size = IMAGE
    rj.fill_back = False
    want = rj.render_rgbad(vs, faces.numpy(), tex.numpy())
    sil = np.asarray(rj.render_silhouettes(vs, faces.numpy()))
    got = rs[0]
    np.testing.assert_array_equal(got['sil'].numpy(), sil)
    np.testing.assert_array_equal(got['alpha'].numpy(),
                                  np.asarray(want['alpha']))
    for k in ('rgb', 'depth'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_batch_sharded_render(face_runs):
    world, _, results = face_runs
    vs, fs, tx, _ = (torch.tensor(a) for a in _scene(2))
    r = _renderer()
    n = BS // world
    for mode in parallel.MODES:
        fn = parallel._render_fn(r, mode)
        want = fn(vs, fs, tx) if mode in ('rgb', 'rgbad') else fn(vs, fs)
        for k, res in enumerate(results):
            got = res['batch'][mode]
            if mode == 'rgbad':
                for key in ('rgb', 'alpha', 'depth'):
                    assert torch.equal(got[key],
                                       want[key][k * n:(k + 1) * n])
            else:
                assert torch.equal(got, want[k * n:(k + 1) * n]), mode


def test_batch_by_faces_grid(tmp_path):
    results = _spawn(_grid_worker, 4, str(tmp_path))
    vs = torch.tensor(_scene(2)[0])
    for b in range(2):
        pair = results[2 * b:2 * b + 2]
        for f, res in enumerate(pair):
            assert res['rgb'].shape[0] == BS // 2
        faces, tex = _shard_order(pair, 'fl', 'tl')
        half = slice(b * BS // 2, (b + 1) * BS // 2)
        want = _renderer(fill_back=False).render_rgbad(
            vs[half], faces[half], tex[half])
        for res in pair:
            for k in ('rgb', 'alpha', 'depth'):
                assert torch.equal(res[k], want[k]), (b, k)


def test_data_parallel_step(tmp_path):
    results = _spawn(_dp_worker, 2, str(tmp_path))
    for res in results:
        assert res['losses'][2] < res['losses'][0], res['losses']
        torch.testing.assert_close(res['vertices'], results[0]['vertices'],
                                   rtol=0, atol=0)
    # the first step's m is (1 - beta1) * grad: the whole batch's gradient
    params, target, loss_fn = _dp_problem()
    leaf = params['vertices'].clone().requires_grad_()
    loss = loss_fn(dict(vertices=leaf), target)
    loss.backward()
    want = 0.1 * leaf.grad
    got = results[0]['m'][0]
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    loss = float(loss.detach())
    assert abs(results[0]['losses'][0] - loss) <= 1e-5 * loss


def _multiview_script():
    spec = importlib.util.spec_from_file_location('torch_multiview_',
                                                  MULTIVIEW)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _multiview_worker(rank, world, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, timing = _multiview_script().run(argv)
    return dict(out=out, timing=timing, printed=buf.getvalue(),
                group_left=dist.is_initialized())


def test_multiview_script_under_torchrun(tmp_path):
    argv = ['--views', '4', '--image_size', '32', '--iters', '1',
            '--device', 'cpu']
    results = _spawn(_multiview_worker, 2, str(tmp_path), argv,
                     port=_free_port())
    script = _multiview_script()
    renderer, v, f, tx, _ = script.build(script.parse_args(argv))
    with torch.no_grad():
        want = renderer.render_rgbad(v, f, tx)
    for k in ('rgb', 'alpha', 'depth'):
        assert [r['out'][k].shape[0] for r in results] == [2, 2], k
        assert torch.equal(torch.cat([r['out'][k] for r in results]),
                           want[k]), k
    assert [r['timing']['ranks'] for r in results] == [2, 2]
    assert results[0]['printed'].startswith(
        '4 views @ 32^2 rgb+alpha+depth over 2 device(s): ')
    assert results[1]['printed'] == ''
    assert not any(r['group_left'] for r in results)
