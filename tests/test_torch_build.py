"""The kernel launch seam of the port (``neural_renderer_torch/_build.py``)
on the CPU, with fake libraries and a fake card: ``library`` declares the
C signatures ``LIBRARIES`` holds for a library and ``nr_error_string`` and
loads it once; every kernel source under ``csrc/`` has its signatures there;
``launch`` enters no device context where the device is current and the
device's own where it is not, passes the device's raw stream as the last
argument, raises with ``nr_error_string``'s text and the entry point's
name where the entry point returns a CUDA error, and counts
``launch.<kernel>`` once for each launch that succeeds (``call`` counts
none)."""

import contextlib
import pathlib
import types

import pytest
import torch

from neural_renderer_torch import _build, tracing


class _FakeLib:
    """Entry points ``nr_probe`` and ``nr_probe_fill`` that record their
    arguments and return ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def nr_probe(self, *args):
        self.calls.append(('nr_probe', args))
        return self.rc

    def nr_probe_fill(self, *args):
        self.calls.append(('nr_probe_fill', args))
        return self.rc

    @staticmethod
    def nr_error_string(rc):
        return f'an illegal memory access ({rc})'.encode()


@pytest.fixture
def card(monkeypatch):
    """Device 0 current; records the devices entered; the raw stream of
    device ``i`` is ``1000 + i``."""
    entered = []

    def device(index):
        entered.append(index)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'device', device)
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream',
                        lambda index: 1000 + index, raising=False)
    tracing.reset()
    yield entered
    tracing.reset()


@pytest.mark.parametrize('index,want_entered', [(0, []), (1, [1])])
def test_launch_enters_only_another_device(card, index, want_entered):
    lib = _FakeLib()
    _build.launch(lib, 'probe', index, 7, None, 2.5)
    assert card == want_entered
    assert lib.calls == [('nr_probe', (7, None, 2.5, 1000 + index))]


def test_launch_counts_once_and_call_never(card):
    lib = _FakeLib()
    _build.call(lib, 'nr_probe', 0, 1)
    assert tracing.counts() == {}
    _build.launch(lib, 'probe', 0, 2, entry='nr_probe_fill')
    assert tracing.counts() == {'launch.probe': 1}
    _build.launch(lib, 'probe', 0, 3)
    assert tracing.counts() == {'launch.probe': 2}
    assert [c[0] for c in lib.calls] == ['nr_probe', 'nr_probe_fill',
                                         'nr_probe']


@pytest.mark.parametrize('entry', [None, 'nr_probe_fill'])
def test_launch_raises_on_a_cuda_error(card, entry):
    lib = _FakeLib(rc=700)
    want = (f'^{entry or "nr_probe"} kernel launch failed: an illegal '
            r'memory access \(700\)$')
    with pytest.raises(RuntimeError, match=want):
        _build.launch(lib, 'probe', 0, 1, entry=entry)
    assert tracing.counts() == {}


def test_library_declares_its_signatures_once(monkeypatch):
    loaded = []

    def cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(**{
            e: types.SimpleNamespace()
            for e in ('nr_probe', 'nr_probe_tile', 'nr_error_string')})

    monkeypatch.setattr(_build, 'build_all',
                        lambda names: {n: (f'lib{n}.so', '') for n in names})
    monkeypatch.setattr(_build.ctypes, 'CDLL', cdll)
    monkeypatch.setitem(_build.LIBRARIES, 'probe', {
        'nr_probe': (_build.I32, (_build.PTR, _build.I64)),
        'nr_probe_tile': (_build.I32, ())})
    _build.library.cache_clear()
    try:
        lib = _build.library('probe')
        assert _build.library('probe') is lib
    finally:
        _build.library.cache_clear()
    assert loaded == ['libprobe.so']
    assert (lib.nr_probe.restype, tuple(lib.nr_probe.argtypes)) == (
        _build.I32, (_build.PTR, _build.I64))
    assert (lib.nr_probe_tile.restype, tuple(lib.nr_probe_tile.argtypes)) \
        == (_build.I32, ())
    assert (lib.nr_error_string.restype,
            tuple(lib.nr_error_string.argtypes)) == (_build.ctypes.c_char_p,
                                                      (_build.I32,))


def test_every_kernel_source_has_a_library():
    csrc = pathlib.Path(_build.__file__).resolve().parent / 'csrc'
    assert sorted(_build.LIBRARIES) == sorted(
        p.stem for p in csrc.glob('*.cu'))


def test_ptr_of_none_is_null():
    t = torch.zeros(3)
    assert _build.ptr(None) is None and _build.ptr(t) == t.data_ptr()
