"""Rasterizer defaults and static settings.

Defaults mirror the reference (``rasterize.py:7-12``):
IMAGE_SIZE=256, ANTI_ALIASING=True, NEAR=0.1, FAR=100, EPS=1e-4,
BACKGROUND_COLOR=(0,0,0).

The port's entry points put what they build from non-tensor inputs on
``DEFAULT_DEVICE``, the card; a caller asks for the CPU with
``device='cpu'`` or by passing CPU tensors.
"""

import dataclasses

import torch

DEFAULT_DEVICE = 'cuda'


def resolve_device(device=None):
    """``device`` (``DEFAULT_DEVICE`` when None) as a ``torch.device``.

    Raises where it names the card and torch sees none: the port never
    falls back to the CPU on its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: neural_renderer_torch runs on the card unless '
            "asked for the CPU; pass device='cpu' (or CPU tensors)")
    return dev


def as_tensors(values, dtype=None, device=None):
    """``values`` as tensors (cast to ``dtype`` where given).  A tensor keeps
    its device; anything else (number, list, numpy array) lands on
    ``device``, else on the device of the first tensor among ``values``,
    else on the card (``resolve_device``)."""
    if device is None:
        device = next((v.device for v in values
                       if isinstance(v, torch.Tensor)), None)
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v if dtype is None else v.to(dtype))
        else:
            out.append(torch.as_tensor(v, dtype=dtype,
                                       device=resolve_device(device)))
    return out


def on_card(t):
    """True for a CUDA tensor (a wrapper launches its kernel), False for a
    CPU tensor (it runs the plain version); any other device raises."""
    if t.device.type == 'cpu':
        return False
    if t.device.type != 'cuda':
        raise ValueError(f'no kernel for device {t.device}')
    return True


DEFAULT_IMAGE_SIZE = 256
DEFAULT_ANTI_ALIASING = True
DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100.0
DEFAULT_EPS = 1e-4
DEFAULT_BACKGROUND_COLOR = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Static rasterizer configuration: the reference ``Rasterize.__init__``
    arguments (``rasterize.py:19-37``).  The background color is a tensor
    operand of ``rasterize_core`` ([3] or per-batch [bs, 3], reference
    rasterize.py:462-465), not static config."""
    image_size: int = DEFAULT_IMAGE_SIZE
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    eps: float = DEFAULT_EPS
    return_rgb: bool = True
    return_alpha: bool = True
    return_depth: bool = True

    def validate(self):
        if not (self.return_rgb or self.return_alpha or self.return_depth):
            raise ValueError('nothing to draw '
                             '(reference rasterize.py:25-27 raises too)')
        return self
