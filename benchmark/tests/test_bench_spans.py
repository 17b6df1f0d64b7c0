"""The readers of the program's own spans (``benchmark/spans.py``) on
hand-made records, and on a traced stretch of a cell on the CPU."""

import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, spans, trace  # noqa: E402

# the span readers' metrics, each with the cell it reads and what it reads
READERS = {
    'port_waits_per_call.train': 'teapot.train_b128',
    'port_waits_per_call.render': 'multiview.rgbad_v64',
    'scene_idle_ms.train': 'teapot.train_b128',
    'scene_idle_ms.render': 'multiview.rgbad_v64',
    'raster_idle_ms.train': 'teapot.train_b128',
    'raster_idle_ms.render': 'multiview.rgbad_v64',
    'backward_idle_ms.train': 'teapot.train_b128',
}


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
        # nested in the scene's span: counted once
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


def test_waits_are_counted_per_call():
    assert spans.waits_per_call(_rec(DEVICE, HOST)) == 1.0
    assert spans.waits_per_call(_rec(DEVICE, HOST, calls=1)) == 2.0


def test_idle_time_goes_to_the_overlapping_layer():
    rec = _rec(DEVICE, HOST)
    # idle: 0-10, 20-40, 50-70, 80-100; scene 0-30 and 95-100: 10 + 10 + 5
    assert spans.idle_ms_per_call(rec, 'scene') == pytest.approx(25e-3 / 2)
    # raster 30-58: 30-40 and 50-58
    assert spans.idle_ms_per_call(rec, 'raster') == pytest.approx(18e-3 / 2)
    # backward 60-95: 60-70 and 80-95
    assert spans.idle_ms_per_call(rec, 'backward') == \
        pytest.approx(25e-3 / 2)
    # the layers are disjoint: what is left (58-60) belongs to none
    total = 100.0 * (1 - trace.busy_seconds(rec) / trace.window_seconds(rec))
    assert total == pytest.approx(70.0)
    parts = sum(spans.idle_ms_per_call(rec, layer)
                for layer in ('scene', 'raster', 'backward'))
    assert parts * 2 == pytest.approx(68e-3)
    assert spans.idle_ms_per_call(rec, 'merge') == 0.0


def test_nested_spans_of_a_layer_count_once():
    host = HOST + [('nr.scene.camera', 0.0, 30.0, 1),
                   ('nr.scene', 0.0, 30.0, 3)]
    assert spans.idle_ms_per_call(_rec(DEVICE, host), 'scene') == \
        pytest.approx(25e-3 / 2)


def test_a_stretch_without_the_programs_spans_reads_nothing():
    bare = [h for h in HOST if not h[0].startswith(spans.PREFIX)]
    rec = _rec(DEVICE, bare)
    assert spans.waits_per_call(rec) is None
    for layer in ('scene', 'raster', 'backward'):
        assert spans.idle_ms_per_call(rec, layer) is None
    for name in READERS:
        assert harness.reader(name).read(rec) is None
    # spans but no device operation: waits are counted, idle is not
    no_device = _rec([], HOST)
    assert spans.waits_per_call(no_device) == 1.0
    assert spans.idle_ms_per_call(no_device, 'scene') is None


@pytest.mark.parametrize('cell', sorted(set(READERS.values())))
def test_a_traced_cpu_stretch_holds_the_spans(cell):
    """The readers on a traced stretch of ``cell`` on the CPU: the
    program's spans are there; no wait is made on the CPU, and with no
    device operation the idle readers read nothing."""
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
    entry = 'nr.' + traffic['entry']
    assert {entry, 'nr.scene', 'nr.raster'} <= names
    assert ('nr.backward' in names) == bool(traffic['grads'])
    for name, reads in READERS.items():
        if reads != cell:
            continue
        got = harness.reader(name).read(rec)
        assert got == (0.0 if name.startswith('port_waits') else None), name
