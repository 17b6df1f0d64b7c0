"""The port's spans and counters (``neural_renderer_torch/tracing.py``) on
the CPU: each entry point's spans under ``torch.profiler`` with their
parents, the shared null context with no profiler running, the counts a
plain CPU render leaves (none), the sites at which a render places its
host values (``config.place``), the host values kept on the card from one
call to the next (its card route driven on the CPU by
``torch_fakes.fake_card_place``), the binning's work counts, with the
kernels of ``csrc/bin_faces.cu`` stood in for by a fake that writes the
pair total where they do, and the texture cells the per-face reduction
expands (``work.k6_cells``) and the reductions that build the K6 factors
(``k6.in_reduce``), with the backward's kernels stood in for by a fake
that launches nothing."""

import ctypes
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import neural_renderer_torch as nt
import torch_fakes
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import backward_cuda, config
from neural_renderer_torch.rasterize import forward_cuda
from neural_renderer_torch.rasterize.config import RasterizeSettings

TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')

SCENE = {('nr.scene', None), ('nr.scene.gather', 'nr.scene'),
         ('nr.scene.lighting', 'nr.scene'), ('nr.scene.camera', 'nr.scene')}
RASTER = {('nr.raster.shade', 'nr.raster'),
          ('nr.raster.composite', 'nr.raster'),
          ('nr.raster.post', 'nr.raster')}
# the backward, on the autograd engine's thread: the call's root, under it
# the rasterizer's backward and the vertex gather's, and the nodes of the
# forward's plain-torch regions; the K6 factors of the ts-2 textures are
# built inside the reduction, so no nr.backward.k6
ROOT = {('nr.backward', None), ('nr.backward.camera', 'nr.backward'),
        ('nr.backward.post', 'nr.backward')}
BACKWARD = ROOT | {('nr.backward', 'nr.backward'),
                   ('nr.backward.lighting', 'nr.backward'),
                   ('nr.backward.k5', 'nr.backward'),
                   ('nr.backward.reduce', 'nr.backward'),
                   ('nr.backward.scatter', 'nr.backward')}


def _under(root, pairs):
    """``pairs`` with the parentless ones hung under ``root``."""
    return {(n, root if p is None else p) for n, p in pairs}


# entry point -> (its (span, parent span) pairs, whether it draws textures)
WANT = {
    'render': (
        {('nr.render', None), ('nr.raster', 'nr.render')}
        | _under('nr.render', SCENE) | RASTER | BACKWARD, True),
    'render_rgbad': (
        {('nr.render_rgbad', None), ('nr.raster', 'nr.render_rgbad')}
        | _under('nr.render_rgbad', SCENE) | RASTER, True),
    'render_silhouettes': (
        {('nr.render_silhouettes', None),
         ('nr.scene', 'nr.render_silhouettes'),
         ('nr.scene.camera', 'nr.scene'), ('nr.scene.gather', 'nr.scene'),
         ('nr.raster', 'nr.render_silhouettes')} | RASTER, False),
    'render_depth': (
        {('nr.render_depth', None), ('nr.scene', 'nr.render_depth'),
         ('nr.scene.camera', 'nr.scene'), ('nr.scene.gather', 'nr.scene'),
         ('nr.raster', 'nr.render_depth'), ('nr.backward', 'nr.backward'),
         ('nr.backward.k7', 'nr.backward'),
         ('nr.backward.reduce', 'nr.backward'),
         ('nr.backward.scatter', 'nr.backward')} | ROOT | RASTER, False),
}
# the entry points run with their backward
BACKWARD_OF = ('render', 'render_depth')


@pytest.fixture(scope='module')
def scene():
    v, f = nt.load_obj(TEAPOT)
    v = torch.as_tensor(v)[None]
    f = torch.as_tensor(f, dtype=torch.int64)[None]
    tx = torch.rand((1, f.shape[1], 2, 2, 2, 3),
                    generator=torch.Generator().manual_seed(5))
    r = nt.Renderer()
    r.image_size = 16
    r.eye = torch.tensor([0.0, 0.5, -2.7])
    return r, v, f, tx


def _call(entry, scene, backward):
    r, v, f, tx = scene
    v = v.clone().requires_grad_(backward)
    tx = tx.clone().requires_grad_(backward)
    textured = WANT[entry][1]
    out = getattr(r, entry)(*((v, f, tx) if textured else (v, f)))
    if isinstance(out, dict):
        out = out['rgb']
    if backward:
        torch.autograd.grad(out.sum(), [v, tx] if textured else [v])


def _nr_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(tracing.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize('entry', sorted(WANT))
def test_entry_points_show_their_spans_and_parents(scene, entry):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(entry, scene, entry in BACKWARD_OF)
    got = {(ev.name, _nr_parent(ev)) for ev in prof.events()
           if ev.name.startswith(tracing.PREFIX)}
    assert got == WANT[entry][0]


def test_no_profiler_no_record_function(scene, monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(tracing, '_RecordFunctionFast', refuse)
    assert tracing.span('render') is tracing.span('raster') is tracing._OFF
    _call('render', scene, True)


def _grads_of_a_step(scene, ts, record=None):
    """The vertex and texture gradients of a training step of ``scene``'s
    teapot at bs 2 with ``ts`` textures; with ``record``, the sequence
    numbers of the autograd nodes made before the call, by the call and
    by its lighting region, in it."""
    r, v, f, _ = scene
    v = v.expand(2, -1, -1).clone().requires_grad_(True)
    f = f.expand(2, -1, -1)
    tx = torch.rand((2, f.shape[1], ts, ts, ts, 3),
                    generator=torch.Generator().manual_seed(ts))
    tx.requires_grad_(True)
    light = r._light

    def lit(*args):
        first = torch._C._autograd._get_sequence_nr()
        out = light(*args)
        record['lighting'] = range(first,
                                   torch._C._autograd._get_sequence_nr())
        return out

    if record is not None:
        record['call'] = torch._C._autograd._get_sequence_nr()
        r._light = lit
    try:
        out = r.render(v, f, tx)
    finally:
        r.__dict__.pop('_light', None)
    return torch.autograd.grad(out.sum(), [v, tx])


def _innermost(at, events):
    """The shortest of ``events`` (name, start, end, ...) that holds the
    event ``at``, or None."""
    hold = [e for e in events if e[1] <= at[1] and at[2] <= e[2]]
    return min(hold, key=lambda e: e[2] - e[1]) if hold else None


@pytest.mark.parametrize('ts', [2, 8])
def test_every_op_of_a_backward_node_runs_under_a_backward_span(scene, ts):
    """Every aten op that a backward node of a traced training step runs,
    on the textures' factor path (ts 2) and above it (ts 8), lies inside
    an ``nr.backward*`` span and inside the root ``nr.backward``, the
    engine's adds of gradients too, but for the loss's ``SumBackward0``
    and the inputs' ``ViewBackward0``; the ops of the lighting region's
    nodes have ``nr.backward.lighting`` as their innermost span.  The
    gradients are bit-equal to an untraced step's."""
    want = _grads_of_a_step(scene, ts)
    seq = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _grads_of_a_step(scene, ts, seq)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    by_thread = {}
    for ev in prof.events():
        by_thread.setdefault(ev.thread, []).append(
            (ev.name, ev.time_range.start, ev.time_range.end,
             ev.sequence_nr))
    # the inputs' views are the call's first nodes
    views = range(seq['call'], seq['call'] + 2)
    checked = lit = 0
    for evs in by_thread.values():
        spans = [e for e in evs if e[0].startswith('nr.')]
        backward = [e for e in spans if e[0].startswith('nr.backward')]
        # one root a step, holding every other backward span
        roots = [e for e in backward if _innermost(e, [
            b for b in backward if b is not e]) is None]
        assert len(roots) == (1 if backward else 0)
        assert roots == [] or roots[0][0] == 'nr.backward'
        nodes = [e for e in evs if e[3] >= 0
                 and not e[0].startswith(('aten::', 'autograd::'))]
        steps = [e for e in evs if e[0].startswith(
            'autograd::engine::evaluate_function: ')]
        for op in evs:
            step = _innermost(op, steps)
            if not op[0].startswith('aten::') or step is None:
                continue
            node = _innermost(op, [n for n in nodes
                                   if n[0] == step[0].split(': ')[1]])
            node = node or _innermost(step, nodes) or min(
                (n for n in nodes if _innermost(n, steps) == step),
                key=lambda n: abs(n[1] - op[1]))
            if node[0] == 'SumBackward0' or (
                    node[0] == 'ViewBackward0' and node[3] in views):
                continue
            assert _innermost(op, backward) is not None, (op, node)
            assert _innermost(op, roots) is not None, (op, node)
            checked += 1
            if node[3] in seq['lighting'] and _innermost(op, nodes):
                assert _innermost(op, spans)[0] == 'nr.backward.lighting', op
                lit += 1
    assert checked and lit


def test_no_profiler_no_hook_and_no_view(scene, monkeypatch):
    """With no profiler, a training step adds no hook and no view."""
    def refuse(*args, **kwargs):
        raise AssertionError('a hook or a view with no profiler')

    monkeypatch.setattr(torch.Tensor, 'view_as', refuse)
    monkeypatch.setattr(torch.Tensor, 'register_hook', refuse)
    monkeypatch.setattr(torch.autograd.graph, 'register_multi_grad_hook',
                        refuse)
    monkeypatch.setattr(tracing, '_mark', refuse)
    _grads_of_a_step(scene, 2)


def test_a_region_marks_only_the_nodes_it_builds(monkeypatch):
    marked = []
    monkeypatch.setattr(tracing, '_mark',
                        lambda node, name: marked.append((node.name(), name)))
    p = torch.ones(3, requires_grad=True)
    a, q = p * 2, p.exp()
    with profile(activities=[ProfilerActivity.CPU]):
        out = tracing.backward('x', lambda a: (a.sin() + q, {'k': a.cos()}),
                               a)
        torch.autograd.grad(out[0].sum() + out[1]['k'].sum(), [p])
    assert sorted(marked) == [('AddBackward0', 'nr.backward.x'),
                              ('CosBackward0', 'nr.backward.x'),
                              ('SinBackward0', 'nr.backward.x')]


def test_a_traced_forward_without_backward_frees_its_graph(scene):
    """The hooks of a traced step hold no node in a cycle: a forward
    dropped without its backward frees the rasterizer's node and the
    gather's, and what they saved, with the collector off."""
    import gc
    import weakref
    r, v, f, tx = scene
    v = v.clone().requires_grad_(True)
    tx = tx.clone().requires_grad_(True)
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = r.render(v, f, tx)
        ours, seen, todo = [], set(), [out.grad_fn]
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if isinstance(node, torch.autograd.function.BackwardCFunction):
                ours.append(weakref.ref(node))
            todo.extend(n for n, _ in node.next_functions)
        del out, node, seen
        alive = [w() for w in ours if w() is not None]
    finally:
        gc.enable()
    assert len(ours) == 2 and not alive


def test_a_cpu_render_counts_nothing(scene):
    tracing.reset()
    for entry in sorted(WANT):
        _call(entry, scene, entry in BACKWARD_OF)
    assert tracing.counts() == {}


# the host values a render places, in order: (site, device) of each
# tracing.host_copy call of a CPU render of the teapot (its faces a tensor)
_LIT = [('renderer.vertices', 'cpu'), ('renderer.textures', 'cpu'),
        ('vertices_to_faces.faces', 'cpu'), ('lighting.color_ambient', 'cpu'),
        ('lighting.color_directional', 'cpu'),
        ('lighting.direction', 'cpu')]
_CAMERA = [('look_at.eye', 'cpu'), ('look_at.at', 'cpu'),
           ('look_at.up', 'cpu'), ('perspective.angle', 'cpu')]
_TEXTURED = _LIT + _CAMERA + [('api.faces', 'cpu'), ('api.textures', 'cpu'),
                              ('api.background', 'cpu')]
_UNLIT = [('renderer.vertices', 'cpu')] + _CAMERA + [
    ('vertices_to_faces.faces', 'cpu'), ('api.faces', 'cpu'),
    ('api.background', 'cpu')]
PLACED = {
    'render': _TEXTURED, 'render_rgbad': _TEXTURED,
    'render_silhouettes': _UNLIT, 'render_depth': _UNLIT,
}
# the sites of PLACED that take host values (the Renderer's lists and
# numbers); the others take the scene's tensors, already on the card
HOST_SITES = {'lighting.color_ambient', 'lighting.color_directional',
              'lighting.direction', 'look_at.at', 'look_at.up',
              'perspective.angle', 'api.background'}


def _card_sites(entry):
    return [s for s, _ in PLACED[entry] if s in HOST_SITES]


@pytest.mark.parametrize('entry', sorted(PLACED))
def test_a_render_places_its_host_values_at_its_sites(scene, monkeypatch,
                                                      entry):
    placed = []
    host_copy = tracing.host_copy

    def record(site, value, device):
        placed.append((site, str(device)))
        return host_copy(site, value, device)

    monkeypatch.setattr(tracing, 'host_copy', record)
    _call(entry, scene, False)
    assert placed == PLACED[entry]


def test_waits_are_counted_and_marked():
    tracing.reset()
    cpu, card = torch.device('cpu'), torch.device('cuda')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.wait('read', 'probe'):
            pass
        # a list or a CPU tensor put on the card is a copy from the host
        with tracing.host_copy('probe', [1.0], card):
            pass
        with tracing.host_copy('probe', torch.zeros(1), card):
            pass
        # nothing leaves the host here
        assert tracing.host_copy('probe', [1.0], cpu) is tracing._OFF
    snapshot = tracing.counts()
    assert snapshot == {'wait.read.probe': 1, 'wait.copy.probe': 2}
    snapshot['wait.read.probe'] = 9
    assert tracing.counts()['wait.read.probe'] == 1
    names = [ev.name for ev in prof.events()
             if ev.name.startswith(tracing.PREFIX)]
    assert sorted(names) == ['nr.wait.copy.probe', 'nr.wait.copy.probe',
                             'nr.wait.read.probe']
    tracing.reset()
    assert tracing.counts() == {}


def test_kept_values_are_counted_apart():
    tracing.reset()
    tracing.kept('probe')
    tracing.kept('probe')
    assert tracing.counts() == {'kept.probe': 2}
    tracing.reset()


@pytest.mark.parametrize('entry', sorted(PLACED))
def test_a_second_call_keeps_every_host_value(scene, monkeypatch, entry):
    """On the card the first call copies each distinct host value once;
    the second copies none and finds each kept at exactly its card
    sites: 7 with lighting, 4 without."""
    torch_fakes.fake_card_place(monkeypatch)
    sites = _card_sites(entry)
    assert len(sites) == (7 if WANT[entry][1] else 4)
    tracing.reset()
    _call(entry, scene, entry in BACKWARD_OF)
    first = tracing.counts()
    assert set(first) <= {f'{k}.{s}' for k in ('wait.copy', 'kept')
                          for s in sites}
    assert sum(first.values()) == len(sites)
    tracing.reset()
    _call(entry, scene, entry in BACKWARD_OF)
    assert tracing.counts() == {f'kept.{s}': 1 for s in sites}
    tracing.reset()


def test_a_render_and_its_backward_leave_kept_values_as_kept(scene,
                                                              monkeypatch):
    torch_fakes.fake_card_place(monkeypatch)
    _call('render', scene, True)
    kept = {k: t.clone() for k, (t, _) in config._PLACED.items()}
    assert kept
    _call('render', scene, True)
    _call('render_rgbad', scene, False)
    assert set(config._PLACED) == set(kept)
    for k, (t, version) in config._PLACED.items():
        assert t.dtype == kept[k].dtype and t._version == version
        assert torch.equal(t.view(-1).view(torch.uint8),
                           kept[k].view(-1).view(torch.uint8))


def test_an_inference_render_then_a_training_step(scene, monkeypatch):
    """Nothing placed in inference mode is kept, so the training step
    after it saves no inference tensor for its backward."""
    torch_fakes.fake_card_place(monkeypatch)
    r, v, f, tx = scene
    with torch.inference_mode():
        r.render(v, f, tx)
    assert not config._PLACED
    _call('render', scene, True)
    assert config._PLACED
    assert not any(t.is_inference() for t, _ in config._PLACED.values())
    with torch.inference_mode():
        r.render(v, f, tx)
    _call('render', scene, True)


def _renderer(**attrs):
    r = nt.Renderer()
    r.image_size = 16
    r.eye = torch.tensor([0.0, 0.5, -2.7])
    for k, a in attrs.items():
        setattr(r, k, a)
    return r


CHANGES = {
    'light_direction': ('lighting.direction', [0.3, 0.8, -0.5]),
    'light_color_ambient': ('lighting.color_ambient', [0.2, 0.4, 1.0]),
    'background_color': ('api.background', [0.5, 0.25, 1.0]),
    'viewing_angle': ('perspective.angle', 20),
}


@pytest.mark.parametrize('attr', sorted(CHANGES) + ['mutated in place'])
def test_a_changed_renderer_renders_its_new_values(scene, monkeypatch,
                                                   attr):
    """A Renderer attribute changed between calls, or a list of it written
    in place, is copied anew and drawn as a fresh Renderer draws it."""
    torch_fakes.fake_card_place(monkeypatch)
    _, v, f, tx = scene
    r = _renderer()
    r.render(v, f, tx)
    tracing.reset()
    if attr == 'mutated in place':
        site, attrs = 'lighting.color_directional', {}
        r.light_color_directional[0] = 0.125
        attrs['light_color_directional'] = [0.125, 1, 1]
    else:
        site, value = CHANGES[attr]
        setattr(r, attr, value)
        attrs = {attr: value}
    got = r.render(v, f, tx)
    assert tracing.counts()[f'wait.copy.{site}'] == 1
    monkeypatch.setattr(config, '_PLACED', type(config._PLACED)())
    assert torch.equal(got, _renderer(**attrs).render(v, f, tx))
    assert not torch.equal(got, _renderer().render(v, f, tx))
    tracing.reset()


class _FakeBinning:
    """The entry points of ``csrc/bin_faces.cu`` on CPU tensors: the count
    writes the pair total where the kernel does (entry ``bs * nf`` of its
    int64 scan), the fill writes nothing."""

    def __init__(self, total):
        self.total = total

    @staticmethod
    def nr_bin_cells(bs, nf, is_, tile):
        nt_ = -(-is_ // tile)
        return bs * nt_ * nt_ * -(-nf // forward_cuda.BIN_CHUNK)

    @staticmethod
    def nr_bin_scan_bytes(bs, nf, is_, tile):
        return 0

    def nr_bin_count(self, faces, bs, nf, is_, tile, rec, irec, rect, count,
                     box, mask, scan, temp, temp_bytes, stream):
        ctypes.c_int64.from_address(scan + 8 * bs * nf).value = self.total
        return 0

    @staticmethod
    def nr_bin_fill(*args):
        return 0


@pytest.mark.parametrize('bs,nf', [(2, 300), (3, 129)])
def test_binning_counts_its_work(monkeypatch, bs, nf):
    settings = RasterizeSettings(image_size=64)
    tile = 16
    fc = torch.as_tensor(np.random.default_rng(bs).uniform(
        -1.0, 1.0, (bs, nf, 3, 3)), dtype=torch.float32)
    fc[..., 2] = fc[..., 2].abs() + 1.0
    total = forward_cuda.bin_faces(settings, fc, tile)[1].numel()
    torch_fakes.fake_card(monkeypatch, forward_cuda, _FakeBinning(total))
    forward_cuda._bin_sizes.cache_clear()
    tracing.reset()
    try:
        out = forward_cuda.bin_setup(settings, fc, tile)
    finally:
        forward_cuda._bin_sizes.cache_clear()
    assert out['ids'].numel() == total > 0
    assert tracing.counts() == {
        'launch.bin_faces': 1, 'wait.read.bin_total': 1,
        'work.faces': bs * nf, 'work.bin_pairs': total,
        'work.bin_cells': bs * 4 * 4 * -(-nf // 128)}
    tracing.reset()


class _FakeBackward:
    """The entry points of ``csrc/backward_sweeps.cu`` and
    ``csrc/face_reduce.cu`` on CPU tensors: each launch returns success and
    writes nothing, so only what the wrappers count is read."""

    @staticmethod
    def nr_outsweep_smem_limit():
        return 227 * 1024

    @staticmethod
    def nr_face_reduce_tile():
        return 16

    @staticmethod
    def nr_insweep(*args):
        return 0

    nr_outsweep = nr_face_reduce = nr_face_grad = nr_insweep


@pytest.fixture
def fake_backward(monkeypatch):
    """The backward's kernels on a faked card, fed the forward's tile lists
    as the card's forward hands them over (``forward_shaded(...)['bins']``,
    here from ``bin_faces`` at the fake's 16-pixel tiles)."""
    plain = forward_cuda.forward_shaded

    def with_bins(settings, faces, textures=None):
        out = plain(settings, faces, textures)
        out['bins'] = dict(zip(('start', 'ids', 'order', 'first'),
                               forward_cuda.bin_faces(settings, faces, 16)),
                           tile=16)
        return out

    monkeypatch.setattr(forward_cuda, 'forward_shaded', with_bins)
    torch_fakes.fake_card(monkeypatch, backward_cuda, _FakeBackward)
    backward_cuda._smem_limit.cache_clear()
    tracing.reset()
    yield
    backward_cuda._smem_limit.cache_clear()
    tracing.reset()


def _textured_step(scene, ts, backward):
    r, v, f, _ = scene
    tx = torch.rand((2, f.shape[1], ts, ts, ts, 3),
                    generator=torch.Generator().manual_seed(ts))
    v = v.repeat(2, 1, 1).requires_grad_(backward)
    tx.requires_grad_(backward)
    with torch.set_grad_enabled(backward):
        out = r.render(v, f.repeat(2, 1, 1), tx)
    if backward:
        torch.autograd.grad(out.sum(), [v, tx])


@pytest.mark.parametrize('ts', [2, 4])
def test_k6_cells_count_the_expanded_texture_cells(scene, fake_backward,
                                                   ts):
    _textured_step(scene, ts, True)
    nf = 2 * scene[2].shape[1]  # after fill_back
    assert tracing.counts()['launch.face_reduce'] == 1
    assert tracing.counts()['work.k6_cells'] == 2 * nf * ts ** 3
    # the tile pass built the factors: no factor planes in plain torch
    assert tracing.counts()['k6.in_reduce'] == 1


@pytest.mark.parametrize('step', ['silhouettes', 'no_grad', 'ts5'])
def test_k6_cells_count_nothing_off_the_factor_path(scene, fake_backward,
                                                    step):
    """A silhouette step reduces with no texture cells, a render under
    no_grad has no backward, and a cube above ts 4 takes the 8-corner
    scatter in place of the factors."""
    if step == 'silhouettes':
        r, v, f, _ = scene
        v = v.clone().requires_grad_(True)
        torch.autograd.grad(r.render_silhouettes(v, f).sum(), [v])
    else:
        _textured_step(scene, 5, step == 'ts5')
    assert tracing.counts().get('work.k6_cells', 0) == 0
    assert tracing.counts().get('k6.in_reduce', 0) == 0
    assert tracing.counts().get('launch.face_reduce', 0) == int(
        step != 'no_grad')
