"""Ambient + directional face lighting of texture cubes.

Reference ``neural_renderer/lighting.py:8-52``: face normal =
normalize(cross(v0 - v1, v2 - v1)), cos = relu(dot(normal, direction)),
``light = Ia*Ca + Id*Cd*cos`` broadcast over the whole per-face texture cube.
Per-face (flat) shading, not per-pixel — matching the reference exactly.
``face_light`` gives the light alone, one rgb value a face, for the route
that applies it where the cube is read (``Renderer._light``); ``lighting``
multiplies the whole cube by it.
"""

import torch

from neural_renderer_torch.ops.cross import cross
from neural_renderer_torch.ops.transforms import _normalize
from neural_renderer_torch.rasterize.config import place


def face_light(
        faces, intensity_ambient=0.5, intensity_directional=0.5,
        color_ambient=(1, 1, 1), color_directional=(1, 1, 1),
        direction=(0, 1, 0)):
    """The per-face ambient + directional light ``[bs, nf, 3]``.

    faces: ``[bs, nf, 3, 3]`` world-space per-face vertex coords.
    """
    bs, nf = faces.shape[:2]
    dev = faces.device

    # [3] (broadcast over the batch) or [bs, 3] each
    color_ambient = place(color_ambient, dev,
                          site='lighting.color_ambient').expand(bs, 3)
    color_directional = place(color_directional, dev,
                              site='lighting.color_directional').expand(bs, 3)
    direction = place(direction, dev,
                      site='lighting.direction').expand(bs, 3)

    light = torch.zeros((bs, nf, 3), dtype=torch.float32, device=dev)

    if not (isinstance(intensity_ambient, (int, float))
            and intensity_ambient == 0):
        light = light + intensity_ambient * color_ambient[:, None, :]

    if not (isinstance(intensity_directional, (int, float))
            and intensity_directional == 0):
        v10 = faces[:, :, 0] - faces[:, :, 1]
        v12 = faces[:, :, 2] - faces[:, :, 1]
        normals = _normalize(cross(v10, v12))
        # max(x, 0) as the JAX package takes it (jnp.maximum): at a face
        # edge-on to the light (x exactly 0, common on axis-aligned scanned
        # geometry) the gradient is halved, where torch.relu's would be 0
        dot = torch.sum(normals * direction[:, None, :], dim=2)
        cos = torch.maximum(dot, dot.new_zeros(()))
        light = light + (intensity_directional
                         * color_directional[:, None, :] * cos[:, :, None])
    return light


def light_cubes(textures, light):
    """``textures [bs, nf, ts, ts, ts, 3]`` scaled by the per-face
    ``light [bs, nf, 3]``."""
    return textures * light[:, :, None, None, None, :]


def lighting(
        faces, textures, intensity_ambient=0.5, intensity_directional=0.5,
        color_ambient=(1, 1, 1), color_directional=(1, 1, 1),
        direction=(0, 1, 0)):
    """Scale ``textures`` by per-face ambient + directional light
    (``face_light``).

    faces: ``[bs, nf, 3, 3]`` world-space per-face vertex coords.
    textures: ``[bs, nf, ts, ts, ts, 3]``.
    """
    return light_cubes(textures, face_light(
        faces, intensity_ambient, intensity_directional, color_ambient,
        color_directional, direction))
