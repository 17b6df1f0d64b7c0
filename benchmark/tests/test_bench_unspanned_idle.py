"""``unspanned_idle_ms``, the device idle that no layer's span holds, on
hand-made records and on a traced stretch of a cell on the CPU, and how it
splits the window's idle with the three layers' idle readers."""

import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, spans, trace  # noqa: E402

# the readers, each with the cell it reads
READERS = {
    'unspanned_idle_ms.train': 'teapot.train_b128',
    'unspanned_idle_ms.render': 'multiview.rgbad_v64',
}
# the readers that split the host stretch's idle in four
IDLE = ('scene_idle_ms.train', 'raster_idle_ms.train',
        'backward_idle_ms.train', 'unspanned_idle_ms.train')


def _rec(device, host, window=(0.0, 100.0), calls=2):
    return dict(calls=calls, device=device, seconds=(window[1] - window[0])
                * 1e-6, host=host, host_device=device, window=window,
                work={})


DEVICE = [('shaded_kernel', 10.0, 20.0, 'kernel'),
          ('elementwise_kernel', 40.0, 50.0, 'kernel'),
          ('outsweep_kernel', 70.0, 80.0, 'kernel')]
HOST = [(trace.WINDOW_SPAN, 0.0, 100.0, 1),
        (trace.CALL_SPAN, 0.0, 100.0, 1),
        ('nr.render', 0.0, 60.0, 1),
        ('nr.scene', 0.0, 30.0, 1),
        ('nr.scene.lighting', 5.0, 25.0, 1),
        ('nr.wait.copy.lighting.direction', 12.0, 14.0, 1),
        ('nr.raster', 30.0, 58.0, 1),
        ('nr.raster.bin_setup', 32.0, 45.0, 1),
        ('nr.wait.read.bin_total', 44.0, 45.0, 1),
        ('aten::mul', 46.0, 55.0, 1),
        # the backward on the autograd engine's thread
        ('nr.backward', 60.0, 95.0, 2),
        ('nr.backward.k5', 62.0, 70.0, 2),
        # a scene span that the window cuts: only 95-100 counts
        ('nr.scene', 95.0, 110.0, 1)]


def test_the_unspanned_idle_is_what_no_layer_holds():
    rec = _rec(DEVICE, HOST)
    # idle 58-60 lies in no layer's span (nr.render and the harness's
    # spans are no layer)
    for name in READERS:
        assert harness.reader(name).read(rec) == pytest.approx(2e-3 / 2)
    # a layer's span on another thread holds the idle too: the backward
    # at 55-60 on the engine's thread takes 58-60
    host = HOST + [('nr.backward.lighting', 55.0, 60.0, 3)]
    assert harness.reader('unspanned_idle_ms.train').read(
        _rec(DEVICE, host)) == 0.0


@pytest.mark.parametrize('host', [
    HOST,
    # a span before the window, one nested in its layer on another thread
    HOST + [('nr.backward', -20.0, -5.0, 2),
            ('nr.backward.post', 84.0, 86.0, 3)],
    [h for h in HOST if not h[0].startswith('nr.backward')]])
def test_the_four_idle_readers_add_up_to_the_windows_idle(host):
    """Where the layers' spans do not overlap, as a call's forward and its
    backward do not."""
    rec = _rec(DEVICE, host)
    idle_ms = (rec['window'][1] - rec['window'][0]) * 1e-3 - \
        trace.busy_seconds(rec) * 1e3
    parts = [harness.reader(name).read(rec) for name in IDLE]
    assert all(p >= 0 for p in parts)
    assert sum(parts) * rec['calls'] == pytest.approx(idle_ms)


def test_a_stretch_without_the_programs_spans_reads_nothing():
    bare = [h for h in HOST if not h[0].startswith(spans.PREFIX)]
    for name in READERS:
        assert harness.reader(name).read(_rec(DEVICE, bare)) is None
        # spans but no device operation: no idle is read
        assert harness.reader(name).read(_rec([], HOST)) is None


@pytest.mark.parametrize('cell', sorted(set(READERS.values())))
def test_a_traced_cpu_stretch_reads_nothing_without_device_ops(cell):
    """The readers on a traced stretch of ``cell`` on the CPU: the
    program's spans are there, but with no device operation the idle
    readers read nothing."""
    import neural_renderer_torch as nt

    bench = harness.load_bench()
    _, cfg, traffic = harness.load_cell(bench, cell)
    cfg.update(image_size=16)
    traffic.update(batch=2, azimuths=dict(start=0, stop=360, count=2))
    prog = harness.Program(nt, cfg, traffic, 2 ** 31 + 7,
                           torch.device('cpu'))
    prog.call(0)
    dev_prof, dev_s = harness._profiled(prog, 1, 2, False)
    host_prof, _ = harness._profiled(prog, 3, 2, True)
    rec = trace.record(dev_prof, host_prof, 2, dev_s)
    names = {n for n, _, _, _ in rec['host'] if n.startswith(spans.PREFIX)}
    assert {'nr.' + traffic['entry'], 'nr.scene', 'nr.raster'} <= names
    for name, reads in READERS.items():
        if reads == cell:
            assert harness.reader(name).read(rec) is None, name
