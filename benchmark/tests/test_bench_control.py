"""The comparison that decides ``correct`` fails what it must: the
lower-precision control in the program's place, and a run whose timed
path is broken underneath.  On the CPU at a small size; the control's
readings at each cell's own size come from ``benchmark/calibrate.py`` on
the card."""

import pathlib
import sys
import time

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from neural_renderer_torch.rasterize import api  # noqa: E402

from benchmark import check, harness, scene  # noqa: E402
from benchmark.reference import renderer as ref  # noqa: E402

BENCH = harness.load_bench()
CELLS = [w['name'] for w in BENCH['workloads']]
CPU = torch.device('cpu')


def _small(cell):
    _, cfg, traffic = harness.load_cell(BENCH, cell)
    cfg['image_size'] = 32
    batch = 4
    # the training cells check some elements of each call, the rgbad cell
    # all of them, as at their own sizes
    elements = 2 if traffic['grads'] else 4
    traffic.update(batch=batch, warmup_calls=1,
                   check=dict(calls=2, elements=elements, block=1))
    if traffic['eyes'] == 'ring':
        traffic['azimuths'] = dict(start=0, stop=360, count=batch)
    return cfg, traffic


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('seed', [1, 2 ** 31 + 3, 2 ** 40 + 5])
def test_the_control_is_not_correct(cell, seed):
    cfg, traffic = _small(cell)
    v, f, t = scene.make(cfg, traffic['batch'], seed, CPU)
    az = scene.azimuths(traffic['azimuths'])
    eye = scene.eye_at(cfg['distance'], cfg['elevation'], az[seed % len(az)])
    if traffic['eyes'] == 'ring':
        eye = torch.stack([scene.eye_at(cfg['distance'], cfg['elevation'], a)
                           for a in az])
    args = (cfg, traffic['entry'], traffic['grads'], v, f, t, eye, 1)
    want = ref.run(*args)
    got = check.control(*args)
    correct, rows = check.judge(check.compare(*got, *want),
                                check.limits(cell))
    assert not correct, rows


def _half_batch(render_pass):
    """Half of the batch left out: the first half rendered, its images
    standing in for the rest."""
    def broken(faces, textures, *args):
        h = max(1, faces.shape[0] // 2)
        out = render_pass(faces[:h], textures[:h], *args)
        reps = -(-faces.shape[0] // h)
        return {k: None if x is None else torch.cat([x] * reps)[
            :faces.shape[0]] for k, x in out.items()}
    return broken


def _altered(render_pass):
    """An answer altered where it is produced: one pixel of each batch
    element's outputs moved by 0.01 (a run checks a sample of the
    elements, so a fault in one element alone is seen only where the
    sample takes it)."""
    def broken(*args):
        out = render_pass(*args)
        res = {}
        for k, x in out.items():
            if x is not None:
                bump = torch.zeros_like(x)
                bump.view(x.shape[0], -1)[:, x[0].numel() // 3] = 0.01
                x = x + bump
            res[k] = x
        return res
    return broken


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', [_half_batch, _altered],
                         ids=['half_batch', 'altered'])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    cfg, traffic = _small(cell)
    sound, _ = harness.run_cell(cell, 77, 0.3, False, time.time(),
                                device='cpu', cfg_over=cfg,
                                traffic_over=traffic)
    assert sound['correct'] is True
    monkeypatch.setattr(api, '_render_pass', fault(api._render_pass))
    broken, rows = harness.run_cell(cell, 77, 0.3, False, time.time(),
                                    device='cpu', cfg_over=cfg,
                                    traffic_over=traffic)
    assert broken['correct'] is False, rows
    assert broken['failed'] > 0
