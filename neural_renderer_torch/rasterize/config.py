"""Rasterizer defaults and static settings.

Defaults mirror the reference (``rasterize.py:7-12``):
IMAGE_SIZE=256, ANTI_ALIASING=True, NEAR=0.1, FAR=100, EPS=1e-4,
BACKGROUND_COLOR=(0,0,0).

The port's entry points put what they build from non-tensor inputs on
``DEFAULT_DEVICE``, the card; a caller asks for the CPU with
``device='cpu'`` or by passing CPU tensors.

``place`` keeps the small host values it copies to the card (a call's
colours, camera defaults, angle and background, the same bytes every call)
in ``_PLACED``, keyed by the card, the dtype asked for and the host array's
dtype, shape and bytes, so a later call with equal values gets the kept
tensor and neither copies nor waits; any other value is a miss and the new
value's copy.
"""

import collections
import dataclasses
import threading

import numpy as np
import torch

from neural_renderer_torch import tracing

DEFAULT_DEVICE = 'cuda'

# host values kept on the card (a call places seven; a few renderers' worth)
_PLACED_KEPT = 32
# the largest host value kept, in elements: per-batch [bs, 3] colours at bs
# 128 and more, never a mesh
_PLACED_MAX_ELEMENTS = 1024
# key -> (the kept tensor, its version counter when kept)
_PLACED = collections.OrderedDict()
# renders on several threads share the table
_PLACED_LOCK = threading.Lock()


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


def place(value, device=None, dtype=torch.float32, *, site=None):
    """``value`` as a ``dtype`` tensor (``dtype`` None: a tensor's own, else
    torch's choice).  A tensor keeps its device unless ``device`` (a
    ``torch.device``) is given; anything else (number, list, numpy array)
    lands on ``device``, else on the card (``resolve_device``), read through
    ``np.asarray`` where ``dtype`` is given (a list of per-batch arrays is
    one array).  Every counted host copy of the port is made here: a copy of
    host data to the card is counted at ``site`` where one is given
    (``tracing.host_copy``), and a small numeric host value copied there is
    kept (``_kept_key``): the same value at any site later returns the kept
    tensor, counted as ``kept.<site>``, with no copy.
    """
    if not isinstance(value, torch.Tensor):
        device = resolve_device(device)
        if dtype is not None:
            value = np.asarray(value)
    elif device is None:
        device = value.device
    if site is None:
        return torch.as_tensor(value, dtype=dtype, device=device)
    key = _kept_key(value, device, dtype)
    if key is not None:
        with _PLACED_LOCK:
            entry = _PLACED.get(key)
            if entry is not None and entry[0]._version == entry[1]:
                _PLACED.move_to_end(key)
                tracing.kept(site)
                return entry[0]
    with tracing.host_copy(site, value, device):
        out = torch.as_tensor(value, dtype=dtype, device=device)
    if key is not None:
        # the copy from pageable memory has synchronized (torch converts
        # the dtype on the host first): the kept tensor is complete before
        # any stream reads it
        with _PLACED_LOCK:
            _PLACED[key] = (out, out._version)
            _PLACED.move_to_end(key)
            if len(_PLACED) > _PLACED_KEPT:
                _PLACED.popitem(last=False)
    return out


def _card_index(device):
    """The index of ``device`` where it is a CUDA device (the current one
    where it names none), else None."""
    if device.type != 'cuda':
        return None
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _kept_key(value, device, dtype):
    """The key under which ``place`` keeps ``value`` (a numpy array once
    read) on ``device`` as ``dtype``, or None where it is not kept: a
    tensor, a target off the card (no copy waits there), no dtype asked, a
    non-numeric array (object dtype holds pointers), one of more than
    ``_PLACED_MAX_ELEMENTS`` elements (a mesh would be hashed every call),
    or inference mode (an inference tensor cannot be saved for a later
    backward)."""
    if isinstance(value, torch.Tensor) or dtype is None:
        return None
    index = _card_index(device)
    if (index is None or value.dtype.kind not in 'biuf'
            or value.size > _PLACED_MAX_ELEMENTS
            or torch.is_inference_mode_enabled()):
        return None
    return (index, dtype, value.dtype.str, value.shape, value.tobytes())


def as_tensors(values, dtype=None, device=None):
    """``values`` placed (``place``, uncounted): a tensor keeps its device;
    anything else lands on ``device``, else on the device of the first
    tensor among ``values``, else on the card."""
    if device is None:
        device = next((v.device for v in values
                       if isinstance(v, torch.Tensor)), None)
    return [place(v, None if isinstance(v, torch.Tensor) else device, dtype)
            for v in values]


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
    rasterize.py:462-465), not static config.

    ``face_group``: a ``torch.distributed`` process group over which the
    face list is sharded (face-axis model parallelism, ``parallel.py``; the
    JAX package's ``face_axis``).  Each rank rasterizes its slice and the
    z-buffers merge across the group (``core._merge_face_group``); None
    renders the faces given alone."""
    image_size: int = DEFAULT_IMAGE_SIZE
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    eps: float = DEFAULT_EPS
    return_rgb: bool = True
    return_alpha: bool = True
    return_depth: bool = True
    face_group: object = None

    def validate(self):
        if not (self.return_rgb or self.return_alpha or self.return_depth):
            raise ValueError('nothing to draw '
                             '(reference rasterize.py:25-27 raises too)')
        return self
