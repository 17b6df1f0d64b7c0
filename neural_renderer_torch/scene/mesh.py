"""Trainable mesh: vertices and per-face texture cubes as an ``nn.Module``.

Mirrors the reference ``Mesh`` chainer.Link (mesh.py:8-38) and the JAX
package's ``scene/mesh.py``: vertices and textures are the trainable
parameters, faces are a fixed int buffer (scene topology, never
differentiated), ``get_batch`` broadcasts to a minibatch and
sigmoid-squashes the textures (mesh.py:33), and per-parameter learning-rate
scales feed the custom ``Adam`` (``optim.py``; reference optimizers.py).
"""

import numpy as np
import torch
from torch import nn

from neural_renderer_torch.io.obj import load_obj
from neural_renderer_torch.rasterize.config import resolve_device


class Mesh(nn.Module):
    """vertices [nv, 3] f32 and textures [nf, ts, ts, ts, 3] f32 (both
    ``nn.Parameter``), faces [nf, 3] int64 (a buffer).

    ``Mesh('file.obj', texture_size=4)`` loads an OBJ like the reference
    constructor (``from_obj`` with seed 0).  Parameters and buffer are built
    on ``device``, the card unless asked otherwise
    (``config.resolve_device``)."""

    def __init__(self, vertices, textures=None, faces=None, texture_size=4,
                 normalization=True, lr_vertices=1.0, lr_textures=1.0,
                 spatial_order=False, device=None):
        super().__init__()
        if spatial_order:
            raise NotImplementedError(
                'spatial_order needs ops/spatial.py, which is not ported yet '
                '(ROADMAP Queue 1, "Tune, checks and the rest of the tail")')
        device = resolve_device(device)
        if isinstance(vertices, str):
            vertices, textures, faces = _obj_arrays(
                vertices, texture_size, normalization, 0)
        self.vertices = nn.Parameter(torch.tensor(
            np.asarray(vertices, np.float32), device=device))
        self.textures = (None if textures is None else nn.Parameter(
            torch.tensor(np.asarray(textures, np.float32), device=device)))
        self.register_buffer('faces', torch.tensor(
            np.asarray(faces, np.int64), device=device))
        self.lr_vertices = lr_vertices
        self.lr_textures = lr_textures

    @classmethod
    def from_obj(cls, filename_obj, texture_size=4, normalization=True,
                 seed=0, device=None):
        """Load an OBJ; textures ~ Normal(0, 0.05) like
        chainer.initializers.Normal (mesh.py:20-22), drawn from
        ``np.random.RandomState(seed)`` as the JAX package draws them."""
        return cls(*_obj_arrays(filename_obj, texture_size, normalization,
                                seed), device=device)

    @property
    def num_vertices(self):
        return self.vertices.shape[0]

    @property
    def num_faces(self):
        return self.faces.shape[0]

    @property
    def texture_size(self):
        return self.textures.shape[1]

    def get_batch(self, batch_size):
        """Broadcast to a minibatch; sigmoid-squash textures (mesh.py:29-34).

        Returns (vertices [bs,nv,3], faces [bs,nf,3], textures
        [bs,nf,ts,ts,ts,3]); the gradient of a broadcast copy sums over the
        batch."""
        vertices = self.vertices.expand(batch_size, *self.vertices.shape)
        faces = self.faces.expand(batch_size, *self.faces.shape)
        textures = torch.sigmoid(
            self.textures.expand(batch_size, *self.textures.shape))
        return vertices, faces, textures

    def set_lr(self, lr_vertices, lr_textures):
        """Per-parameter LR scales for ``Adam`` (mesh.py:36-38); read when
        the optimizer is built from ``lr_scales()``.  Returns self."""
        self.lr_vertices = lr_vertices
        self.lr_textures = lr_textures
        return self

    def lr_scales(self):
        """Parameter groups for ``Adam``, each with its ``lr_scale``."""
        groups = [dict(params=[self.vertices], lr_scale=self.lr_vertices)]
        if self.textures is not None:
            groups.append(dict(params=[self.textures],
                               lr_scale=self.lr_textures))
        return groups


def _obj_arrays(filename_obj, texture_size, normalization, seed):
    vertices, faces = load_obj(filename_obj, normalization)
    rng = np.random.RandomState(seed)
    textures = rng.normal(
        0.0, 0.05, (faces.shape[0],) + (texture_size,) * 3 + (3,)
    ).astype(np.float32)
    return vertices, textures, faces
