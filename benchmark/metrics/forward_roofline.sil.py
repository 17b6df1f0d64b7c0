"""The forward's share of its roofline in a training cell, in %: the
reader of ``forward_roofline.render`` (its work and its kernels, with the
outputs the cell draws) under a name of its own, since the cells that
report it move ``train_images_per_s``."""

import pathlib

from benchmark import harness, trace

_RENDER = harness.reader('forward_roofline.render',
                         pathlib.Path(__file__).resolve().parents[2])
NAME = 'forward_roofline.sil'
KERNELS = _RENDER.KERNELS
work = _RENDER.work


def read(rec):
    return trace.roofline_pct(rec, NAME, KERNELS)
