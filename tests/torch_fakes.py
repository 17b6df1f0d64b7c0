"""A fake card for the port's tests on the CPU."""

import contextlib

from neural_renderer_torch import _build


def fake_card(monkeypatch, module, lib):
    """Send ``module``'s CPU tensors down its card route, with ``lib``
    standing in for every kernel library that ``_build`` loads and launches
    run with no device context on stream 0."""
    monkeypatch.setattr(module, 'on_card', lambda t: True)
    monkeypatch.setattr(_build, 'library', lambda name: lib)
    monkeypatch.setattr(_build, 'current_device',
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(_build, 'raw_stream', lambda index: 0)
