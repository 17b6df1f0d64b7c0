"""A fake card for the port's tests on the CPU."""

import collections
import contextlib

import torch

from neural_renderer_torch import _build, tracing
from neural_renderer_torch.rasterize import config


def fake_card(monkeypatch, module, lib):
    """Send ``module``'s CPU tensors down its card route, with ``lib``
    standing in for every kernel library that ``_build`` loads and launches
    run with no device context on stream 0."""
    monkeypatch.setattr(module, 'on_card', lambda t: True)
    monkeypatch.setattr(_build, 'library', lambda name: lib)
    monkeypatch.setattr(_build, 'current_device',
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(_build, 'raw_stream', lambda index: 0)


def fake_card_place(monkeypatch):
    """Send ``config.place``'s CPU targets down a card's route, from an
    empty table of kept values: a host value placed on the CPU is kept as
    on card ``index[0]`` (0; a test may change it) and its copy is counted
    as a copy to the card, while a tensor counts as one already there.
    Returns ``index``."""
    index = [0]
    monkeypatch.setattr(config, '_card_index', lambda device: index[0])
    monkeypatch.setattr(config, '_PLACED', collections.OrderedDict())
    monkeypatch.setattr(
        tracing, 'host_copy',
        lambda site, value, device: tracing._OFF
        if isinstance(value, torch.Tensor) else tracing.wait('copy', site))
    return index
