"""The port's entry points run on the card unless asked for the CPU.

Non-tensor inputs, ``Mesh`` parameters and ``convert``'s tensors go to the
CUDA device by default.  Where torch has no card (``torch.cuda.
is_available`` is made False here, whatever the machine) the defaults raise
a clear error instead of handing back CPU tensors; ``device='cpu'`` and CPU
tensors keep working on the CPU.

``config.place`` keeps the small host values it copies to the card; its
card route is driven here on the CPU (``torch_fakes.fake_card_place``).
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
import torch_fakes
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import config
from neural_renderer_torch.rasterize.config import as_tensors, place

TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')
NO_CARD = 'no CUDA device'


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _mesh():
    v = np.array([[0.5, 0.5, 1.], [-0.5, -0.5, 1.], [0.5, -0.5, 1.]],
                 np.float32)
    f = np.array([[0, 1, 2]], np.int64)
    t = np.zeros((1, 2, 2, 2, 3), np.float32)
    return v, t, f


@pytest.mark.parametrize('entry', [
    'arrays_from_numpy', 'render_silhouettes', 'render', 'rasterize',
    'Mesh', 'Mesh.from_obj', 'mesh_from_jax', 'renderer_from_jax', 'tune',
    'get_points_from_angles', 'cross'])
def test_default_device_raises_without_a_card(no_card, entry):
    v, t, f = _mesh()
    calls = {
        'arrays_from_numpy': lambda: nt.arrays_from_numpy(v, f),
        'render_silhouettes': lambda: nt.Renderer().render_silhouettes(
            v[None], f[None]),
        'render': lambda: nt.Renderer().render(v[None], f[None], t[None]),
        'rasterize': lambda: nt.rasterize(v[None, None].repeat(3, 2),
                                          t[None]),
        'Mesh': lambda: nt.Mesh(v, t, f),
        'Mesh.from_obj': lambda: nt.Mesh.from_obj(TEAPOT),
        'mesh_from_jax': lambda: nt.mesh_from_jax(nr.Mesh(v, t, f)),
        'renderer_from_jax': lambda: nt.renderer_from_jax(nr.Renderer()),
        'tune': lambda: nt.tune(nt.Renderer(), v, f),
        'get_points_from_angles': lambda: nt.get_points_from_angles(
            np.float32(2.732), np.float32(30.), np.float32(45.)),
        'cross': lambda: nt.cross(v[0], v[1]),
    }
    with pytest.raises(RuntimeError, match=NO_CARD):
        calls[entry]()


def test_cpu_when_asked(no_card):
    """``device='cpu'`` and CPU tensors stay on the CPU."""
    v, t, f = _mesh()
    vt, ft, tt = nt.arrays_from_numpy(v[None], f[None], t[None],
                                      device='cpu')
    assert {x.device.type for x in (vt, ft, tt)} == {'cpu'}
    mesh = nt.Mesh(v, t, f, device='cpu')
    assert {p.device.type for p in (mesh.vertices, mesh.textures,
                                    mesh.faces)} == {'cpu'}
    r = nt.renderer_from_jax(nr.Renderer(), device='cpu')
    r.image_size = 16
    sil = r.render_silhouettes(vt, ft)
    assert sil.device.type == 'cpu' and float(sil.max()) == 1.0
    az = np.array([0., 45.], np.float32)
    eyes = nt.get_points_from_angles(az + 2.732, az + 30., az, device='cpu')
    assert eyes.device.type == 'cpu' and eyes.shape == (2, 3)
    # a non-tensor operand lands beside the tensor one
    assert nt.cross(torch.as_tensor(v[0]), v[1]).device.type == 'cpu'
    assert nt.cross(v[0], v[1], device='cpu').device.type == 'cpu'


@pytest.mark.parametrize('dtype', [torch.float32, torch.int64])
def test_place_reads_a_list_of_arrays_or_tensors_as_one_array(dtype):
    """A list of per-batch arrays, or of CPU tensors, is one host array
    (numpy's reading, as the rasterizer's inputs always had)."""
    rows = [np.arange(3.) + 3 * i for i in range(4)]
    want = torch.as_tensor(np.stack(rows), dtype=dtype)
    cpu = torch.device('cpu')
    for value in (rows, [torch.as_tensor(r) for r in rows]):
        got = place(value, cpu, dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def test_as_tensors_keeps_torch_dtypes():
    """With no dtype asked, a list of floats is torch's float32 and a tensor
    keeps its own dtype."""
    a, b = as_tensors([[1., 2.], torch.zeros(2, dtype=torch.float64)])
    assert (a.dtype, b.dtype) == (torch.float32, torch.float64)
    assert a.device == b.device == torch.device('cpu')


CPU = torch.device('cpu')
# host values a call places, and what each is as a tensor of the dtype asked
HOST_VALUES = {
    'int list': ([1, 1, 1], torch.float32),
    'float tuple': ((0.0, 1.0, 0.0), torch.float32),
    'number': (30, torch.float32),
    'per-batch array': (np.arange(384, dtype=np.float32).reshape(128, 3),
                        torch.float32),
    'int64 faces': (np.array([[0, 1, 2]]), torch.int64),
    'bool': ([True, False], torch.bool),
}


@pytest.mark.parametrize('name', sorted(HOST_VALUES))
def test_a_kept_value_is_the_copy_bit_for_bit(monkeypatch, name):
    value, dtype = HOST_VALUES[name]
    torch_fakes.fake_card_place(monkeypatch)
    tracing.reset()
    first = place(value, CPU, dtype, site='probe')
    assert tracing.counts() == {'wait.copy.probe': 1}
    again = place(value, CPU, dtype, site='probe')
    assert tracing.counts() == {'wait.copy.probe': 1, 'kept.probe': 1}
    want = torch.as_tensor(np.asarray(value), dtype=dtype)
    assert again is first
    assert again.dtype == dtype and again.device == CPU
    assert again.shape == want.shape and torch.equal(again, want)
    tracing.reset()


def _change(kind, index):
    """(first value, first dtype, the value placed after ``kind``'s change,
    its dtype)."""
    if kind == 'value':
        return [0, 1, 0], torch.float32, [1, 0, 0], torch.float32
    if kind == 'list mutated in place':
        color = [1.0, 1.0, 1.0]
        before = list(color)
        color[1] = 0.25
        return before, torch.float32, color, torch.float32
    if kind == 'dtype asked':
        return [1, 2, 3], torch.float32, [1, 2, 3], torch.float64
    if kind == 'host dtype':
        return np.array([0.1, 0.2], np.float64), torch.float32, \
            np.array([0.1, 0.2], np.float32), torch.float32
    if kind == 'shape':
        return [[1, 2], [3, 4]], torch.float32, [1, 2, 3, 4], torch.float32
    assert kind == 'device index'
    index[0] = 0
    return [1, 1, 1], torch.float32, [1, 1, 1], torch.float32


@pytest.mark.parametrize('kind', [
    'value', 'list mutated in place', 'dtype asked', 'host dtype', 'shape',
    'device index'])
def test_a_changed_value_misses_and_is_the_value_used(monkeypatch, kind):
    index = torch_fakes.fake_card_place(monkeypatch)
    first, dtype0, then, dtype1 = _change(kind, index)
    tracing.reset()
    place(first, CPU, dtype0, site='probe')
    if kind == 'device index':
        index[0] = 1
    got = place(then, CPU, dtype1, site='probe')
    assert tracing.counts() == {'wait.copy.probe': 2}
    want = torch.as_tensor(np.asarray(then), dtype=dtype1)
    assert got.dtype == dtype1 and got.shape == want.shape
    assert torch.equal(got, want)
    # both are kept now, each under its own key
    assert len(config._PLACED) == 2
    tracing.reset()


NEVER_KEPT = {
    'a tensor': lambda: place(torch.ones(3), CPU, site='probe'),
    'over the size limit': lambda: place(
        np.ones(config._PLACED_MAX_ELEMENTS + 1), CPU, site='probe'),
    'no dtype asked': lambda: place([1.0, 2.0], CPU, None, site='probe'),
    'no site': lambda: place([1.0, 2.0], CPU),
}


@pytest.mark.parametrize('name', sorted(NEVER_KEPT))
def test_what_is_never_kept(monkeypatch, name):
    torch_fakes.fake_card_place(monkeypatch)
    tracing.reset()
    a, b = NEVER_KEPT[name](), NEVER_KEPT[name]()
    assert a is not b and torch.equal(a, b)
    assert not config._PLACED
    assert not any(k.startswith('kept.') for k in tracing.counts())
    tracing.reset()


def test_an_object_array_is_never_kept(monkeypatch):
    """Its bytes are pointers: it goes down the copy's path, which refuses
    it as it always did."""
    torch_fakes.fake_card_place(monkeypatch)
    for _ in range(2):
        with pytest.raises(TypeError):
            place(np.array([1.0, 2.0], dtype=object), CPU, site='probe')
    assert not config._PLACED


def test_nothing_is_kept_off_the_card():
    """A CPU target (no fake here) copies nothing that waits."""
    tracing.reset()
    before = dict(config._PLACED)
    a, b = (place([1.0, 2.0], CPU, site='probe') for _ in range(2))
    assert a is not b and torch.equal(a, b)
    assert dict(config._PLACED) == before
    assert tracing.counts() == {}


def test_nothing_is_kept_in_inference_mode(monkeypatch):
    torch_fakes.fake_card_place(monkeypatch)
    tracing.reset()
    with torch.inference_mode():
        a, b = (place([1.0, 2.0], CPU, site='probe') for _ in range(2))
    assert a.is_inference() and a is not b and torch.equal(a, b)
    assert not config._PLACED
    assert tracing.counts() == {'wait.copy.probe': 2}
    # outside it the same value is copied once and then kept
    c = place([1.0, 2.0], CPU, site='probe')
    assert not c.is_inference()
    assert place([1.0, 2.0], CPU, site='probe') is c
    tracing.reset()


def test_the_table_is_bounded_and_drops_the_oldest(monkeypatch):
    torch_fakes.fake_card_place(monkeypatch)
    n = config._PLACED_KEPT
    kept = [place([float(i)], CPU, site='probe') for i in range(n)]
    assert len(config._PLACED) == n
    # a hit makes value 0 the newest, so value 1 is the oldest
    assert place([0.0], CPU, site='probe') is kept[0]
    newest = place([float(n)], CPU, site='probe')
    assert len(config._PLACED) == n
    tracing.reset()
    assert place([1.0], CPU, site='probe') is not kept[1]
    assert place([0.0], CPU, site='probe') is kept[0]
    assert place([float(n)], CPU, site='probe') is newest
    assert tracing.counts() == {'wait.copy.probe': 1, 'kept.probe': 2}
    # value 1's copy took a place: value 2 went
    assert len(config._PLACED) == n
    assert place([2.0], CPU, site='probe') is not kept[2]
    tracing.reset()


def test_a_kept_tensor_written_since_is_not_returned(monkeypatch):
    torch_fakes.fake_card_place(monkeypatch)
    tracing.reset()
    first = place([1.0, 2.0], CPU, site='probe')
    first.add_(1.0)
    again = place([1.0, 2.0], CPU, site='probe')
    assert again is not first
    assert torch.equal(again, torch.tensor([1.0, 2.0]))
    assert tracing.counts() == {'wait.copy.probe': 2}
    # the new copy is kept in its place
    assert place([1.0, 2.0], CPU, site='probe') is again
    tracing.reset()


def test_threads_share_the_table(monkeypatch):
    """More threads than cores place more values than the table holds, the
    interpreter switching threads often: every value comes back right and
    the table stays bounded."""
    torch_fakes.fake_card_place(monkeypatch)
    # a small table, so that entries go while other threads use them
    monkeypatch.setattr(config, '_PLACED_KEPT', 4)
    workers = 2 * (os.cpu_count() or 1) + 2
    errors = []

    def work(w):
        try:
            for i in range(2000):
                v = [float(w % 3), float(i % 6)]
                if not torch.equal(place(v, CPU, site='probe'),
                                   torch.tensor(v)):
                    errors.append((w, i))
        except Exception as err:   # reported below, with its thread
            errors.append((w, repr(err)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(config._PLACED) <= config._PLACED_KEPT
    tracing.reset()
