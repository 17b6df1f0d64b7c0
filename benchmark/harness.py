"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the traced stretch, the check against the plain reference, the result.

Everything particular to a cell is found by name: its configuration file
(``BENCHMARK.json``'s ``configs``), its traffic (``traffic/<traffic>.json``,
read by the one loop below), its limits (``limits/<cell>.json``) and each
of its metrics (``metrics/<metric>.py``, a ``read(rec)`` that returns a
number or None).  End-to-end readers get the window's record, per-layer
readers the traced stretch's (``trace.record``); a per-layer reader may
also define ``work(stretch)``, the counts its roofline share needs.

The loop is closed, with one client: call ``i`` sets the renderer's eye
(``eyes: cycle``: azimuth ``(offset + i) % count`` for the whole batch;
``ring``: the ring of ``batch`` eyes rotated by ``(offset + i) %
count``), calls the traffic's ``entry`` and takes the gradients of the
images' sum with respect to its ``grads``; with ``sync_each_call`` it
synchronizes and times each call (``rec['call_seconds']``).  The seed
draws the textures, the offset and the answers that are checked; every
seed gives the same work.

The check (``check`` in the traffic): ``calls`` calls of the window drawn
from the seed as they come, and in each ``elements`` batch elements, one
from each of as many equal strata of the batch, drawn from the seed.  Each
element's images and gradients depend on that element alone, so each is
an answer of its own; the reference recomputes them in blocks of
``block`` elements once the window has closed.
"""

import contextlib
import gc
import importlib.util
import json
import pathlib
import random
import sys
import time

import torch

from benchmark import check, scene, trace
from benchmark.reference import raster
from benchmark.reference import renderer as ref

REPO = scene.ROOT.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'neural_renderer_tpu')
# idle host time at each end of a profiled stretch: the card's timestamps
# stray from the host's by milliseconds, and the profiler drops device
# events outside its window
PROFILE_PAD_S = 0.05
# the traced stretch starts once this share of the window has passed
TRACE_AT = 0.25


class RunError(RuntimeError):
    """A run that must end with no result."""


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_bench(root=REPO):
    return json.loads((pathlib.Path(root) / 'BENCHMARK.json').read_text())


def named(items, name, what):
    for it in items:
        if it['name'] == name:
            return it
    raise RunError(f'BENCHMARK.json has no {what} named {name!r}')


def load_traffic(mix, root=REPO):
    path = pathlib.Path(root) / 'benchmark' / 'traffic' / f'{mix}.json'
    return json.loads(path.read_text())


def load_cell(bench, name, root=REPO):
    """(cell entry, configuration dict, traffic dict) of cell ``name``."""
    root = pathlib.Path(root)
    cell = named(bench['workloads'], name, 'workload')
    conf = named(bench['configs'], cell['config'], 'configuration')
    cfg = json.loads((root / conf['file']).read_text())
    return cell, cfg, load_traffic(cell['traffic'], root)


def cell_metrics(bench, name):
    """(end-to-end, per-layer) metric entries that cell ``name`` reports.
    An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one without it is every cell's that reports its ``moves``."""
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if (name in m['workloads'] if 'workloads' in m
                 else m['moves'] in names)]
    return e2e, layer


def reader(name, root=REPO):
    """The module ``benchmark/metrics/<name>.py``."""
    path = pathlib.Path(root) / 'benchmark' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def _prebuild(nt):
    """Build every CUDA source of the program at once (it builds each at
    first use otherwise, one after another); only the first run in a
    checkout compiles."""
    csrc = pathlib.Path(nt.__file__).resolve().parent / 'csrc'
    nt._build.build_all(sorted(p.stem for p in csrc.glob('*.cu')))


class Program:
    """The system under test, driven by one traffic: the program's
    ``Renderer`` and the inputs, eyes and leaves of every call."""

    def __init__(self, nt, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        batch = traffic['batch']
        self.vertices, self.faces, self.textures = scene.make(
            cfg, batch, seed, device)
        r = nt.Renderer()
        for key in ('image_size', 'anti_aliasing', 'fill_back',
                    'viewing_angle', 'near', 'far', 'rasterizer_eps',
                    'background_color'):
            setattr(r, key, cfg[key])
        self.renderer = r
        azimuths = scene.azimuths(traffic['azimuths'])
        eyes = torch.stack([scene.eye_at(cfg['distance'], cfg['elevation'],
                                         a) for a in azimuths]).to(device)
        if traffic['eyes'] == 'cycle':
            self.eyes = list(eyes)
        elif traffic['eyes'] == 'ring':
            if len(azimuths) != batch:
                raise RunError('a ring needs one eye per batch element')
            self.eyes = [torch.roll(eyes, -k, 0) for k in range(batch)]
        else:
            raise RunError(f"unknown eyes {traffic['eyes']!r}")
        self.offset = random.Random(seed).randrange(len(self.eyes))
        self.grads = list(traffic['grads'])
        self.leaves = {'vertices': self.vertices, 'textures': self.textures}
        for g in self.grads:
            self.leaves[g] = self.leaves[g].detach().requires_grad_(True)
        self.fn = getattr(r, traffic['entry'])
        self.sync = traffic['sync_each_call']

    def eye(self, i):
        return self.eyes[(self.offset + i) % len(self.eyes)]

    def call(self, i):
        """Call ``i``: (images, {name: gradient})."""
        self.renderer.eye = self.eye(i)
        args = [self.leaves['vertices'], self.faces]
        if self.traffic['entry'] != 'render_silhouettes':
            args.append(self.leaves['textures'])
        if not self.grads:
            with torch.no_grad():
                return self.fn(*args), {}
        out = self.fn(*args)
        got = torch.autograd.grad(out.sum(),
                                  [self.leaves[g] for g in self.grads])
        return out.detach(), dict(zip(self.grads, got))

    def inputs(self, i, idx):
        """The inputs of batch elements ``idx`` of call ``i``: (vertices,
        faces, textures, eye)."""
        at = torch.tensor(idx, device=self.device)
        eye = self.eye(i)
        return (self.vertices.index_select(0, at),
                self.faces.index_select(0, at),
                self.textures.index_select(0, at),
                eye.index_select(0, at) if eye.ndim == 2 else eye)

    def synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)


class Stretch:
    """The inputs of a traced stretch's calls, as the per-layer readers'
    ``work`` functions need them, worked out by the plain reference.
    Batch elements whose faces a call draws alike are counted once, with
    their number as a weight: the counts are sums over elements."""

    def __init__(self, prog, first, calls):
        self.prog, self.cfg = prog, prog.cfg
        self.entry = prog.traffic['entry']
        self.size = ref.raster_size(self.cfg)
        self.outputs = {'render': ('rgb',), 'render_silhouettes': ('alpha',),
                        'render_rgbad': ('rgb', 'alpha', 'depth')}[self.entry]
        self.keys = [(first + i + prog.offset) % len(prog.eyes)
                     for i in range(calls)]
        self._faces, self._fim = {}, {}

    def faces_ndc(self, key):
        """(the distinct NDC faces ``[u, nf', 3, 3]`` the rasterizer of
        call ``key`` draws, how many batch elements each stands for)."""
        if key not in self._faces:
            p = self.prog
            fc = ref.raster_faces(self.cfg, self.entry, p.vertices, p.faces,
                                  p.eyes[key])
            flat, counts = torch.unique(fc.reshape(fc.shape[0], -1), dim=0,
                                        return_counts=True)
            self._faces[key] = (flat.reshape(-1, *fc.shape[1:]), counts)
        return self._faces[key]

    def face_index(self, key, block):
        """The reference's face-index map of ``faces_ndc(key)``, in blocks
        of ``block`` elements."""
        if key not in self._fim:
            fc, _ = self.faces_ndc(key)
            s = raster.Settings(self.size)
            self._fim[key] = torch.cat([
                raster.face_index_map(s, fc[b:b + block])
                for b in range(0, fc.shape[0], block)])
        return self._fim[key]

    def per_call(self, fn):
        """The mean over the stretch's calls of ``fn(key)``, a dict of
        numbers."""
        each = {key: fn(key) for key in set(self.keys)}
        n = len(self.keys)
        return {k: sum(each[key][k] for key in self.keys) / n
                for k in each[self.keys[0]]}


def _span(name, on):
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


def _profiled(prog, first, calls, host):
    """Profile ``calls`` calls from call ``first``: (profile, seconds on
    the host clock from the synchronized start to the synchronize that
    ends them).  Without ``host`` only the device is traced, so the host
    runs at its own pace; with it every host operation is recorded too,
    with the harness's spans (``trace.WINDOW_SPAN``, ``CALL_SPAN``,
    ``SYNC_SPAN``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if prog.device.type == 'cuda' else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    prog.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        with _span(trace.WINDOW_SPAN, host):
            for i in range(first, first + calls):
                with _span(trace.CALL_SPAN, host):
                    prog.call(i)
                    if prog.sync:
                        with _span(trace.SYNC_SPAN, host):
                            prog.synchronize()
            with _span(trace.SYNC_SPAN, host):
                prog.synchronize()
        seconds = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    return prof, seconds


class Sample:
    """The answers that are checked: ``calls`` calls of the window drawn
    from the seed as they come (a reservoir), and in each ``elements``
    batch elements, one from each of as many equal strata of the batch.
    Only the drawn elements' outputs are kept."""

    def __init__(self, spec, batch, seed):
        self.k = spec['calls']
        self.per = min(spec['elements'], batch)
        self.batch = batch
        self.rng = random.Random(seed)
        self.seen, self.items = 0, []

    def _elements(self):
        edges = [self.batch * j // self.per for j in range(self.per + 1)]
        return [self.rng.randrange(edges[j], edges[j + 1])
                for j in range(self.per)]

    def _keep(self, i, out):
        images, grads = out
        if self.per == self.batch:
            return i, list(range(self.batch)), images, grads
        idx = self._elements()
        at = torch.tensor(idx, device=_first(images).device)

        def pick(x):
            return x.index_select(0, at)

        images = ({k: pick(v) for k, v in images.items()}
                  if isinstance(images, dict) else pick(images))
        return i, idx, images, {k: pick(v) for k, v in grads.items()}

    def offer(self, i, out):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(self._keep(i, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = self._keep(i, out)


def _first(images):
    return next(iter(images.values())) if isinstance(images, dict) \
        else images


def run_cell(name, seed, seconds, traced, start, device='cuda', bench=None,
             cfg_over=None, traffic_over=None, root=REPO, traffic=None):
    """One run of cell ``name``; returns the result dict (the last line)
    and the compared rows [(name, value, limit)].  ``traffic`` names a mix
    to drive in place of the cell's own (the host probe's)."""
    import neural_renderer_torch as nt

    bench = bench or load_bench(root)
    cell, cfg, mix = load_cell(bench, name, root)
    if traffic is not None:
        mix = load_traffic(traffic, root)
    cfg.update(cfg_over or {})
    mix.update(traffic_over or {})
    lim = check.limits(name, root)
    e2e, layer = cell_metrics(bench, name)
    dev = torch.device(device)
    marks = [('start', start), ('imports', time.time())]
    if dev.type == 'cuda':
        _prebuild(nt)
    marks.append(('build', time.time()))

    prog = Program(nt, cfg, mix, seed, dev)
    prog.synchronize()
    marks.append(('inputs', time.time()))
    for i in range(mix['warmup_calls']):
        prog.call(i)
    prog.synchronize()
    marks.append(('warm-up', time.time()))
    gc.collect()
    # what set-up made lives on: keep the collector from walking it
    gc.freeze()
    setup_peak = 0
    if dev.type == 'cuda':
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - start
    log('set-up: ' + ', '.join(f'{what} {b - a:.3f} s' for (_, a), (what, b)
                                in zip(marks, marks[1:])))

    sample = Sample(mix['check'], mix['batch'], seed ^ 0x5A5A)
    times = []
    stretch = out = None
    n = 0
    # calls issued by each whole second of the window: a spread between
    # runs shows here as the seconds in which the host fell behind
    by_second = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if time.perf_counter() - t0 >= len(by_second) + 1:
            by_second.append(n)
        if (traced and stretch is None
                and time.perf_counter() - t0 >= TRACE_AT * seconds):
            calls = mix['trace_calls']
            dev_prof, dev_s = _profiled(prog, n, calls, False)
            host_prof, _ = _profiled(prog, n + calls, calls, True)
            stretch = (n, calls, dev_prof, dev_s, host_prof)
            n += 2 * calls
            continue
        c0 = time.perf_counter()
        out = prog.call(n)
        if prog.sync:
            prog.synchronize()
            times.append(time.perf_counter() - c0)
        sample.offer(n, out)
        n += 1
    prog.synchronize()
    window_s = time.perf_counter() - t0
    log('calls issued in each second of the window: '
        + ' '.join(str(b - a) for a, b in zip([0] + by_second, by_second)))
    del out
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)

    rec = dict(calls=n, seconds=window_s, batch=mix['batch'],
               call_seconds=times, peak_bytes=peak, setup_s=setup_s)
    metrics = {}
    device_rec = dict(
        platform='gpu' if dev.type == 'cuda' else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == 'cuda'
              else 'cpu'),
        count=cell['chips'],
        memory_peak_bytes=max(peak, setup_peak))
    breakdown = None
    if not traced:
        for m in e2e:
            metrics[m['name']] = dict(value=reader(m['name'], root).read(rec),
                                      unit=m['unit'])
    else:
        if stretch is None:
            raise RunError('the window ended before its traced stretch')
        values, trec = _read_layers(prog, layer, stretch, root)
        missing = [k for k, v in values.items() if v is None]
        if missing:
            raise RunError(f'the traced stretch gave nothing for {missing}: '
                           'no launch of the kernels they read was caught')
        for m in layer:
            metrics[m['name']] = dict(value=values[m['name']],
                                      unit=m['unit'])
        device_rec['busy_s'] = trace.busy_seconds(trec)
        device_rec['window_s'] = trace.window_seconds(trec)
        breakdown = trace.breakdown(trec)
        del stretch, trec

    # the program's state goes before the reference runs
    kept = sample.items
    del prog.renderer, prog.fn
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    readings = []
    block = mix['check']['block']
    r0 = time.perf_counter()
    for i, idx, images, grads in kept:
        want = ref.run(cfg, mix['entry'], mix['grads'],
                       *prog.inputs(i, idx), block)
        readings.append(check.compare(images, grads, *want))
    log(f'reference: {sum(len(k[1]) for k in kept)} answers of {len(kept)} '
        f'calls checked in {time.perf_counter() - r0:.3f} s')
    correct, rows = check.judge(check.worst(readings), lim)
    result = dict(correct=correct, attempted=n,
                  failed=sum(not check.judge(r, lim)[0] for r in readings),
                  metrics=metrics, device=device_rec)
    if breakdown is not None:
        result['breakdown'] = breakdown
    # the numbers compared, each beside its limit: the line's last key
    result['checks'] = {k: dict(value=v, limit=l) for k, v, l in rows}
    return result, rows


def _read_layers(prog, layer, stretch, root):
    """{metric: value or None} of a traced stretch, and its record."""
    first, calls, dev_prof, dev_s, host_prof = stretch
    inputs = Stretch(prog, first, calls)
    mods = {m['name']: reader(m['name'], root) for m in layer}
    work = {k: mod.work(inputs) for k, mod in mods.items()
            if hasattr(mod, 'work')}
    rec = trace.record(dev_prof, host_prof, calls, dev_s, work)
    return {k: mod.read(rec) for k, mod in mods.items()}, rec
