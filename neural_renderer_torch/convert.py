"""Carry state from the JAX package over to the port.

``renderer_from_jax`` copies the settings of a ``neural_renderer_tpu``
``Renderer`` (camera, light, image size, anti-aliasing, background,
fill_back, near/far/eps) onto a new ``Renderer`` of this package.  It reads
the attributes by name and never imports JAX: lists stay Python values, and
arrays (numpy or anything ``np.asarray`` accepts) become tensors on the given
device.  The JAX renderer's ``perf_overrides`` are TPU knobs with no
counterpart here and are not copied.

Every function here builds on the card unless ``device`` says otherwise
(``config.resolve_device``); without a card the default raises.

``arrays_from_numpy`` turns mesh arrays (e.g. from ``load_obj``, or the JAX
``Mesh.get_batch`` after ``np.asarray``) into tensors, and ``mesh_from_jax``
a JAX ``Mesh`` into this package's ``Mesh``.
"""

import numpy as np
import torch

from neural_renderer_torch.rasterize.config import resolve_device
from neural_renderer_torch.scene.mesh import Mesh
from neural_renderer_torch.scene.renderer import Renderer

# every Renderer setting, in the order of the JAX Renderer's __init__
RENDERER_FIELDS = (
    'image_size', 'anti_aliasing', 'background_color', 'fill_back',
    'perspective', 'viewing_angle', 'eye', 'camera_mode', 'camera_direction',
    'near', 'far',
    'light_intensity_ambient', 'light_intensity_directional',
    'light_color_ambient', 'light_color_directional', 'light_direction',
    'rasterizer_eps',
)


def _value(v, device):
    """Python scalars, strings and lists stay Python values; a tensor moves
    to ``device``; any other array becomes a tensor there (0-d arrays become
    Python scalars)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return type(v)(_value(x, device) for x in v)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    if arr.dtype.kind == 'f':
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)


def renderer_from_jax(r, device=None):
    """A ``neural_renderer_torch.Renderer`` with every setting of the JAX
    renderer ``r`` (duck-typed: any object with the same attributes); its
    array settings become tensors on ``device``."""
    device = resolve_device(device)
    out = Renderer()
    for name in RENDERER_FIELDS:
        setattr(out, name, _value(getattr(r, name), device))
    return out


def arrays_from_numpy(vertices, faces, textures=None, device=None):
    """Mesh arrays -> (vertices f32, faces int64, textures f32 or None)
    tensors on ``device``."""
    device = resolve_device(device)
    vertices = torch.tensor(np.asarray(vertices, np.float32), device=device)
    faces = torch.tensor(np.asarray(faces, np.int64), device=device)
    if textures is not None:
        textures = torch.tensor(np.asarray(textures, np.float32),
                                device=device)
    return vertices, faces, textures


def mesh_from_jax(m, device=None):
    """A ``neural_renderer_torch.Mesh`` holding the arrays of the JAX mesh
    ``m`` (duck-typed: ``vertices``, ``textures``, ``faces``,
    ``lr_vertices``, ``lr_textures`` and ``face_order``, the permutation a
    spatially ordered mesh carries), on ``device``."""
    textures = None if m.textures is None else np.asarray(m.textures)
    mesh = Mesh(np.asarray(m.vertices), textures, np.asarray(m.faces),
                lr_vertices=m.lr_vertices, lr_textures=m.lr_textures,
                device=device)
    order = getattr(m, 'face_order', None)
    mesh.face_order = None if order is None else np.asarray(order, np.int32)
    return mesh
