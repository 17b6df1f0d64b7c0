"""Wavefront OBJ / MTL loading (host numpy).

Port of the JAX package's ``io/obj.py`` loaders, which follow the reference
``neural_renderer/load_obj.py``.  Parsing semantics are preserved exactly
(``v``/``f`` lines only, polygon fan triangulation, 1-indexed -> 0-indexed,
unit-cube normalization); the reference's K8 GPU kernel
(``load_obj.py:91-143``) is vectorized numpy: each face's ts^3 texture cube
is filled by mapping texel barycentrics through the face's UVs and bilinearly
sampling the MTL texture image.  Only the pure-Python OBJ parser is ported.

Deliberate fixes vs the reference (documented deviations):
  * ``load_mtl`` stores ``Kd`` colors as float arrays (the reference keeps a
    Python-2 ``map`` object — broken on load, load_obj.py:21);
  * bilinear sampling clamps to the image border instead of reading out of
    bounds (load_obj.py:115-128 reads row H / col W);
  * texel (0,0,0)'s degenerate barycentric (0/0) samples the first UV vertex
    instead of propagating NaN.
"""

import os

import numpy as np

from neural_renderer_torch.io.image import imread


def load_mtl(filename_mtl):
    """Load Kd colors and map_Kd texture filenames per material
    (reference load_obj.py:9-22)."""
    texture_filenames = {}
    colors = {}
    material_name = ''
    with open(filename_mtl) as f:
        for line in f.readlines():
            parts = line.split()
            if len(parts) != 0:
                if parts[0] == 'newmtl':
                    material_name = parts[1]
                if parts[0] == 'map_Kd':
                    texture_filenames[material_name] = parts[1]
                if parts[0] == 'Kd':
                    colors[material_name] = np.array(
                        [float(v) for v in parts[1:4]], np.float32)
    return colors, texture_filenames


def _bilinear_sample(image, pos_x, pos_y):
    """Truncation-corner bilinear sample matching load_obj.py:115-128
    (indices clamped to the border instead of reading out of bounds)."""
    h, w = image.shape[:2]
    x0 = np.clip(pos_x.astype(np.int64), 0, w - 1)
    y0 = np.clip(pos_y.astype(np.int64), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    wx1 = (pos_x - x0)[..., None]
    wx0 = 1.0 - wx1
    wy1 = (pos_y - y0)[..., None]
    wy0 = 1.0 - wy1
    return (image[y0, x0] * (wx0 * wy0) + image[y1, x0] * (wx0 * wy1)
            + image[y0, x1] * (wx1 * wy0) + image[y1, x1] * (wx1 * wy1))


def load_textures(filename_obj, filename_mtl, texture_size):
    """Build [nf, ts, ts, ts, 3] texture cubes from OBJ UVs + MTL materials
    (reference load_obj.py:25-144, K8)."""
    ts = texture_size

    # load texture (vt) vertices
    vt = []
    with open(filename_obj) as f:
        lines = f.readlines()
    for line in lines:
        parts = line.split()
        if parts and parts[0] == 'vt':
            vt.append([float(v) for v in parts[1:3]])
    vt = np.vstack(vt).astype(np.float32)

    # faces of texture indices, fan-triangulated; '0' (-> -1 -> wraps to the
    # last vt, like Python-2 negative indexing) when a corner has no UV.
    faces = []
    material_names = []
    material_name = ''
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == 'f':
            vs = parts[1:]
            nv = len(vs)
            v0 = int(vs[0].split('/')[1]) if '/' in vs[0] else 0
            for i in range(nv - 2):
                v1 = int(vs[i + 1].split('/')[1]) if '/' in vs[i + 1] else 0
                v2 = int(vs[i + 2].split('/')[1]) if '/' in vs[i + 2] else 0
                faces.append((v0, v1, v2))
                material_names.append(material_name)
        if parts[0] == 'usemtl':
            material_name = parts[1]
    faces = np.vstack(faces).astype(np.int64) - 1
    face_uv = vt[faces]                                  # [nf, 3, 2]
    face_uv[1 < face_uv] = face_uv[1 < face_uv] % 1      # load_obj.py:66

    colors, texture_filenames = load_mtl(filename_mtl)

    nf = face_uv.shape[0]
    textures = np.zeros((nf, ts, ts, ts, 3), np.float32) + 0.5
    material_names = np.array(material_names)

    # flat Kd colors
    for material_name, color in colors.items():
        sel = material_names == material_name
        textures[sel] = color[None, None, None, None, :]

    # texel barycentrics (load_obj.py:95-104): dims over the cube, then
    # normalized to sum 1.
    idx = np.arange(ts * ts * ts)
    dims = np.stack([(idx // (ts * ts)) % ts, (idx // ts) % ts, idx % ts],
                    axis=-1).astype(np.float32) / (ts - 1.0)
    dim_sum = dims.sum(-1, keepdims=True)
    with np.errstate(invalid='ignore'):
        dims = np.where(dim_sum > 0, dims / dim_sum, 0.0)   # texel 0: corner

    for material_name, filename_texture in texture_filenames.items():
        filename_texture = os.path.join(
            os.path.dirname(filename_obj), filename_texture)
        image = imread(filename_texture).astype(np.float32) / 255.0
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        image = image[::-1, :, :3]                      # load_obj.py:86
        sel = material_names == material_name
        if not sel.any():
            continue
        uv = face_uv[sel]                               # [m, 3, 2]
        # pos = sum_k uv_k * dim_k, scaled to pixel coords
        pos = np.einsum('mkc,tk->mtc', uv, dims)        # [m, ts^3, 2]
        pos_x = pos[..., 0] * (image.shape[1] - 1)
        pos_y = pos[..., 1] * (image.shape[0] - 1)
        sampled = _bilinear_sample(image, pos_x, pos_y)  # [m, ts^3, 3]
        textures[sel] = sampled.reshape(-1, ts, ts, ts, 3)

    return textures


def load_obj(filename_obj, normalization=True, texture_size=4,
             load_texture=False):
    """Load a Wavefront .obj (reference load_obj.py:146-197).

    Supports ``v`` and ``f`` lines (+ ``vt``/``mtllib`` when load_texture).
    Returns (vertices [nv,3] f32, faces [nf,3] i32[, textures]).

    Negative OBJ indices resolve to proper relative indexing (the
    reference's blanket ``- 1`` at load_obj.py:175 mis-resolves negatives by
    one — deliberate fix, as in the JAX package).
    """
    with open(filename_obj) as f:
        lines = f.readlines()

    # single pass so negative (relative) face indices resolve against the
    # vertices seen SO FAR
    vertices = []
    faces = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == 'v':
            vertices.append([float(v) for v in parts[1:4]])
        elif parts[0] == 'f':
            nvert = len(vertices)
            idx = [int(c.split('/')[0]) for c in parts[1:]]
            idx = [i - 1 if i > 0 else nvert + i for i in idx]
            for k in range(len(idx) - 2):
                faces.append((idx[0], idx[k + 1], idx[k + 2]))
    vertices = np.vstack(vertices).astype(np.float32)
    faces = np.asarray(faces, np.int32)

    textures = None
    if load_texture:
        for line in lines:
            if line.startswith('mtllib'):
                filename_mtl = os.path.join(
                    os.path.dirname(filename_obj), line.split()[1])
                textures = load_textures(
                    filename_obj, filename_mtl, texture_size)
        if textures is None:
            raise RuntimeError('Failed to load textures.')

    if normalization:
        # normalize into a unit cube centered at zero (load_obj.py:188-192)
        vertices = vertices - vertices.min(0)[None, :]
        vertices = vertices / np.abs(vertices).max()
        vertices = vertices * 2
        vertices = vertices - vertices.max(0)[None, :] / 2

    if load_texture:
        return vertices, faces, textures
    return vertices, faces
