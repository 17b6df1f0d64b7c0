"""The harness on the CPU: BENCHMARK.json against its schema, cells and
metrics found by name, the result line's keys, the trace arithmetic, and
runs without a card."""

import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, trace  # noqa: E402

BENCH = json.loads((REPO / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
RESULT_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']
# a CPU run small enough for a test: 16^2, two batch elements
SMALL_CFG = dict(image_size=16)


def small_traffic(cell):
    tr = dict(warmup_calls=2, trace_calls=3, batch=4,
              check=dict(calls=2, elements=2, block=1))
    if 'rgbad' in cell:
        tr.update(azimuths=dict(start=0, stop=360, count=4),
                  check=dict(calls=2, elements=4, block=2))
    return tr


def run_small(cell, seed=2 ** 31 + 5, root=REPO, bench=None, seconds=0.5):
    return harness.run_cell(cell, seed, seconds, False, time.time(),
                            device='cpu', bench=bench, cfg_over=SMALL_CFG,
                            traffic_over=small_traffic(cell), root=root)


def test_top_level_keys_and_limits():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'benchmark/run.py']
    assert BENCH['paths'] == ['benchmark']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((REPO / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
    runs = 2 + 14 * 24
    assert runs * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = set()
    for kind, keys in (('configs', {'name', 'source', 'file', 'reduced',
                                    'why'}),
                       ('workloads', {'name', 'config', 'traffic', 'chips',
                                      'why'}),
                       ('end_to_end', {'name', 'unit', 'better', 'bound',
                                       'source'}),
                       ('per_layer', {'name', 'unit', 'better', 'source',
                                      'layer', 'moves'})):
        for e in BENCH[kind]:
            assert set(e) - {'workloads'} == keys, e['name']
            assert NAME.match(e['name']), e['name']
            assert e['name'] not in names
            names.add(e['name'])
            if 'unit' in e:
                assert UNIT.match(e['unit']) and e['better'] in (
                    'lower', 'higher')
                assert e['source'] in ('device_trace', 'program_span',
                                       'program_counter', 'host_clock')
            for text in (e.get('why'), e.get('layer'), e.get('source')):
                if text is not None:
                    assert 1 <= len(text) <= 200 and '\n' not in text
    for w in BENCH['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] == 1


def test_every_cell_resolves_by_name():
    configs = {c['name'] for c in BENCH['configs']}
    used = set()
    for w in BENCH['workloads']:
        cell, cfg, traffic = harness.load_cell(BENCH, w['name'])
        used.add(w['config'])
        conf = harness.named(BENCH['configs'], w['config'], 'configuration')
        assert conf['reduced'] == cfg['reduced']
        assert traffic['entry'] in ('render', 'render_silhouettes',
                                    'render_rgbad')
        assert (REPO / 'benchmark' / 'limits' / f"{w['name']}.json").exists()
        e2e, layer = harness.cell_metrics(BENCH, w['name'])
        assert any(m['name'] == 'setup_s' for m in e2e) and len(e2e) >= 2
        assert layer
        for m in e2e + layer:
            assert hasattr(harness.reader(m['name']), 'read')
    assert used == configs
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    assert all(f.startswith('benchmark/') for f in files)


def test_each_layer_metric_moves_what_its_cells_report():
    for m in BENCH['per_layer']:
        assert m['workloads']
        for cell in m['workloads']:
            e2e, _ = harness.cell_metrics(BENCH, cell)
            assert m['moves'] in {x['name'] for x in e2e}, (m['name'], cell)
    layers = {}
    for m in BENCH['per_layer']:
        layers.setdefault(m['layer'], set()).add(m['name'])
    assert len(layers) >= 3


def test_result_line_has_the_required_keys():
    result, rows = run_small('teapot.train_b128')
    # the required keys, and last the numbers compared beside their limits
    assert list(result) == RESULT_KEYS + ['checks']
    assert result['correct'] is True and result['failed'] == 0
    assert result['attempted'] > 0
    assert set(result['checks']) == {k for k, _, _ in rows}
    assert set(result['metrics']) == {'train_images_per_s', 'peak_mem_gib',
                                      'setup_s'}
    for k in ('platform', 'kind', 'count', 'memory_peak_bytes'):
        assert k in result['device']
    json.dumps(result)


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_every_cell_runs_on_the_cpu_and_is_correct(cell):
    result, _ = run_small(cell)
    assert result['correct'] is True
    for k, v in result['checks'].items():
        assert v['value'] <= v['limit'], k


def _copy(tmp_path):
    root = tmp_path / 'checkout'
    root.mkdir()
    shutil.copy(REPO / 'BENCHMARK.json', root)
    shutil.copytree(REPO / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    return root


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A traffic, a limits file, a metric and a cell added as new files and
    new entries, with no existing file of the benchmark edited."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / 'benchmark').rglob('*')
              if p.is_file()}
    bench_dir = root / 'benchmark'
    traffic = json.loads((bench_dir / 'traffic' / 'train_b32.json')
                         .read_text())
    traffic.update(batch=3, azimuths=dict(start=10, stop=370, count=3))
    (bench_dir / 'traffic' / 'train_b3.json').write_text(json.dumps(traffic))
    (bench_dir / 'limits' / 'teapot.train_b3.json').write_text(
        (bench_dir / 'limits' / 'teapot.train_b128.json').read_text())
    (bench_dir / 'metrics' / 'calls_per_window.train_b3.py').write_text(
        'def read(rec):\n    return rec["calls"] / rec["seconds"]\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['workloads'].append(dict(
        name='teapot.train_b3', config='teapot_256aa_ts2',
        traffic='train_b3', chips=1, why='a test cell'))
    bench['end_to_end'].append(dict(
        name='calls_per_window.train_b3', unit='calls/s', better='higher',
        bound=0.05, source='host_clock', workloads=['teapot.train_b3']))
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    result, _ = harness.run_cell(
        'teapot.train_b3', 9, 0.3, False, time.time(), device='cpu',
        cfg_over=SMALL_CFG, traffic_over=dict(
            warmup_calls=1, check=dict(calls=1, elements=3, block=1)),
        root=root)
    assert result['correct'] is True
    assert set(result['metrics']) == {'calls_per_window.train_b3',
                                      'setup_s'}
    assert result['metrics']['calls_per_window.train_b3']['value'] > 0


def _rec(device, host, window, calls=2):
    """One stretch standing for both: the device's, and the host's."""
    return dict(calls=calls, device=device, seconds=(window[1] - window[0])
                * 1e-6, host=host, host_device=device, window=window,
                work={})


def test_trace_arithmetic():
    dev = [('shaded_kernel', 10.0, 20.0, 'kernel'),
           ('elementwise_kernel', 15.0, 30.0, 'kernel'),
           ('Memcpy HtoD (Pageable -> Device)', 40.0, 45.0, 'copy'),
           ('outsweep_kernel<true>', 60.0, 80.0, 'kernel')]
    host = [(trace.WINDOW_SPAN, 0.0, 100.0, 1),
            (trace.CALL_SPAN, 0.0, 50.0, 1),
            ('cudaStreamSynchronize', 32.0, 38.0, 1),
            (trace.SYNC_SPAN, 85.0, 100.0, 1),
            ('cudaDeviceSynchronize', 86.0, 99.0, 1),
            ('aten::mul', 47.0, 58.0, 2)]
    rec = _rec(dev, host, (0.0, 100.0))
    assert trace.device_ops_per_call(rec) == 2.0
    assert trace.busy_seconds(rec) == pytest.approx(45e-6)
    assert trace.idle_pct(rec) == pytest.approx(55.0)
    assert trace.kernel_seconds(rec, ('outsweep_kernel',)) == \
        pytest.approx(20e-6)
    assert trace.kernel_seconds(rec, ('shaded_', 'outsweep_'),
                                exclude=True) == pytest.approx(15e-6)
    assert trace.kernel_seconds(rec, ('nothing',)) is None
    assert trace.host_waits_per_call(rec) == 1.0
    rec['work']['x'] = dict(bytes=3.35e12 * 5e-6, ops=0)
    assert trace.roofline_pct(rec, 'x', ('outsweep_kernel',)) == \
        pytest.approx(100.0 * 5e-6 / 10e-6)
    assert trace.roofline_pct(rec, 'x', ('missing',)) is None
    b = trace.breakdown(rec)
    assert b['device_ops'][0] == ['outsweep_kernel', pytest.approx(20e-6)]
    gaps = dict(b['idle_gaps'])
    # gaps: 0-10 and 30-40 in the call span, 45-60 in aten::mul, 80-100
    # in the harness's synchronize
    assert gaps[trace.CALL_SPAN] == pytest.approx(10e-6)
    assert gaps['cudaStreamSynchronize'] == pytest.approx(10e-6)
    assert gaps['aten::mul'] == pytest.approx(15e-6)
    assert gaps['cudaDeviceSynchronize'] == pytest.approx(20e-6)
    assert trace.idle_pct(_rec([], host, (0.0, 100.0))) is None
    assert trace.short_name(
        'void (anonymous namespace)::outsweep_kernel<true, 3>(float*)') \
        == 'outsweep_kernel'


def test_the_sample_takes_one_element_from_each_stratum():
    spec = dict(calls=3, elements=8, block=8)
    a, b = harness.Sample(spec, 128, 2 ** 40 + 1), harness.Sample(
        spec, 128, 2 ** 40 + 1)
    images = torch.arange(128.0)[:, None].repeat(1, 5)
    grads = {'vertices': torch.arange(128.0)[:, None, None].repeat(1, 2, 3)}
    for i in range(20):
        a.offer(i, (images, grads))
        b.offer(i, (images, grads))
    assert [x[:2] for x in a.items] == [x[:2] for x in b.items]
    assert len(a.items) == 3 and a.seen == 20
    for i, idx, got, g in a.items:
        assert [j // 16 for j in idx] == list(range(8))
        assert got[:, 0].tolist() == [float(j) for j in idx]
        assert g['vertices'][:, 0, 0].tolist() == [float(j) for j in idx]
    whole = harness.Sample(dict(calls=1, elements=64, block=8), 64, 5)
    whole.offer(0, (images[:64], {}))
    assert whole.items[0][1] == list(range(64))
    assert whole.items[0][2] is not None


def _python(code, cwd=REPO, env=None):
    return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_harness_and_its_readers_load_no_jax():
    code = (
        'import sys, runpy, pathlib\n'
        'sys.argv = ["run.py"]\n'
        'runpy.run_path("benchmark/run.py", run_name="not_main")\n'
        'import neural_renderer_torch\n'
        'from benchmark import harness\n'
        'b = harness.load_bench()\n'
        'for kind in ("end_to_end", "per_layer"):\n'
        '    for m in b[kind]:\n'
        '        harness.reader(m["name"])\n'
        'found = {m.split(".")[0] for m in sys.modules} & '
        '{"jax", "jaxlib", "flax", "neural_renderer_tpu"}\n'
        'print(sorted(found))\n')
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    proc = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'teapot.train_b128',
         '--seed', str(2 ** 33 + 1), '--seconds', '1', '--trace', '0'],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'no CUDA device' in proc.stderr


def test_the_host_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    proc = subprocess.run(
        [sys.executable, 'benchmark/host_probe.py', '--child',
         'teapot.train_b128', 'train_b32', '7', '1'],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''


def test_the_benchmark_alone_does_not_run(tmp_path):
    """Without the program beside it the command exits non-zero and
    prints no result."""
    root = _copy(tmp_path)
    proc = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'teapot.train_b128',
         '--seed', '3', '--seconds', '1', '--trace', '0'],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def test_a_cell_runs_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'teapot.train_b128',
         '--seed', str(2 ** 31 + 99), '--seconds', '2', '--trace', '0'],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'] is True
    assert math.isfinite(result['metrics']['train_images_per_s']['value'])


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_the_work_counts_of_a_traced_stretch(cell):
    """Each per-layer reader's ``work`` on a small stretch of the cell on
    the CPU: positive counts, the same as on every batch element alone."""
    import neural_renderer_torch as nt
    from benchmark import roofline
    from benchmark.reference import renderer as ref

    _, cfg, traffic = harness.load_cell(BENCH, cell)
    cfg.update(SMALL_CFG)
    traffic.update(small_traffic(cell))
    prog = harness.Program(nt, cfg, traffic, 2 ** 31 + 1, torch.device('cpu'))
    stretch = harness.Stretch(prog, 0, 3)
    _, layer = harness.cell_metrics(BENCH, cell)
    works = [harness.reader(m['name']).work(stretch) for m in layer
             if hasattr(harness.reader(m['name']), 'work')]
    assert works
    for w in works:
        assert w['bytes'] > 0 and w['ops'] > 0
    key = stretch.keys[0]
    faces, weights = stretch.faces_ndc(key)
    assert int(weights.sum()) == traffic['batch']
    whole = ref.raster_faces(cfg, traffic['entry'], prog.vertices,
                             prog.faces, prog.eyes[key])
    size = ref.raster_size(cfg)
    assert roofline.forward_work(whole, 2, size, ('rgb',)) == \
        roofline.forward_work(faces, 2, size, ('rgb',), weights)


def test_the_probes_duty_cycle_ends_with_the_run():
    from benchmark import host_probe
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, '-c',
                             'import time; time.sleep(0.3)'])
    host_probe._duty_cycle(proc)
    took = time.perf_counter() - t0
    assert proc.returncode == 0
    # stopped for a quarter of the time, the sleep still ends
    assert 0.3 <= took < 30
