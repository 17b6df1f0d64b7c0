"""Wavefront OBJ / MTL load and save (host numpy).

Port of the JAX package's ``io/obj.py``, which follows the reference
``neural_renderer/load_obj.py`` and ``save_obj.py``.  Parsing semantics are
preserved exactly (``v``/``f`` lines only, polygon fan triangulation,
1-indexed -> 0-indexed, unit-cube normalization); the reference's GPU
kernels become vectorized numpy:

  * K8 (``load_obj.py:91-143``): fill each face's ts^3 texture cube by
    mapping texel barycentrics through the face's UVs and bilinearly
    sampling the MTL texture image;
  * K9/K10 (``save_obj.py:32-140``): bake per-face texture cubes into a 2D
    tiled atlas and fix the diagonal seam.

The v/f hot path of ``load_obj`` uses the native parser (``io/native.py``)
where ``g++`` can build it, else the pure-Python parser.

Deliberate fixes vs the reference (documented deviations):
  * ``load_mtl`` stores ``Kd`` colors as float arrays (the reference keeps a
    Python-2 ``map`` object — broken on load, load_obj.py:21);
  * bilinear sampling clamps to the image border instead of reading out of
    bounds (load_obj.py:115-128 reads row H / col W);
  * texel (0,0,0)'s degenerate barycentric (0/0) samples the first UV vertex
    instead of propagating NaN;
  * atlas tiles beyond num_faces are left black instead of reading OOB.
"""

import os

import numpy as np

from neural_renderer_torch.io.image import imread, imsave01


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


def _parse_obj(filename_obj):
    """The pure-Python v/f parser: (vertices [nv,3] f32, faces [nf,3] i32).
    One pass, so negative (relative) face indices resolve against the
    vertices seen so far, as the native parser resolves them."""
    with open(filename_obj) as f:
        lines = f.readlines()
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
    return np.vstack(vertices).astype(np.float32), np.asarray(faces, np.int32)


def load_obj(filename_obj, normalization=True, texture_size=4,
             load_texture=False, use_native=True):
    """Load a Wavefront .obj (reference load_obj.py:146-197).

    Supports ``v`` and ``f`` lines (+ ``vt``/``mtllib`` when load_texture).
    Returns (vertices [nv,3] f32, faces [nf,3] i32[, textures]).

    The v/f hot path uses the native C++ parser (``csrc/fast_obj.cpp``)
    when ``use_native`` and the toolchain is available; both parsers
    resolve negative OBJ indices to proper relative indexing (the
    reference's blanket ``- 1`` at load_obj.py:175 mis-resolves negatives
    by one — deliberate fix, as in the JAX package).
    """
    parsed = None
    if use_native:
        from neural_renderer_torch.io import native
        parsed = native.parse_obj(filename_obj)

    if parsed is not None:
        vertices, faces = parsed
    else:
        vertices, faces = _parse_obj(filename_obj)

    textures = None
    if load_texture:
        with open(filename_obj) as f:
            lines = f.readlines()
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


def _face_inv(p0, p1, p2):
    """Barycentric matrices of the atlas triangles (save_obj.py:55-66)."""
    denom = (p2[..., 0] * (p0[..., 1] - p1[..., 1])
             + p0[..., 0] * (p1[..., 1] - p2[..., 1])
             + p1[..., 0] * (p2[..., 1] - p0[..., 1]))
    rows = np.stack([
        np.stack([p1[..., 1] - p2[..., 1], p2[..., 0] - p1[..., 0],
                  p1[..., 0] * p2[..., 1] - p2[..., 0] * p1[..., 1]], -1),
        np.stack([p2[..., 1] - p0[..., 1], p0[..., 0] - p2[..., 0],
                  p2[..., 0] * p0[..., 1] - p0[..., 0] * p2[..., 1]], -1),
        np.stack([p0[..., 1] - p1[..., 1], p1[..., 0] - p0[..., 0],
                  p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1]], -1),
    ], axis=-2)
    return rows / denom[..., None, None]


def create_texture_image(textures, texture_size_out=16):
    """Bake per-face texture cubes into a tiled 2D atlas.

    Reference save_obj.py:10-148 (K9 barycentric resample + K10 seam fix).
    textures: [nf, tsi, tsi, tsi, 3] (numpy array or tensor).
    Returns (image [H, W, 3] float, uv vertices [nf, 3, 2] in [0,1]).
    """
    if hasattr(textures, 'detach'):
        textures = textures.detach().cpu().numpy()
    textures = np.asarray(textures, np.float32)
    num_faces, tsi = textures.shape[:2]
    tso = texture_size_out
    eps = 1e-5
    tile_width = int((num_faces - 1.0) ** 0.5) + 1
    tile_height = int((num_faces - 1.0) / tile_width) + 1
    H, W = tile_height * tso, tile_width * tso

    face_nums = np.arange(num_faces)
    column = face_nums % tile_width
    row = face_nums // tile_width
    vertices = np.zeros((num_faces, 3, 2), np.float32)
    vertices[:, 0, 0] = column * tso
    vertices[:, 0, 1] = row * tso
    vertices[:, 1, 0] = column * tso
    vertices[:, 1, 1] = (row + 1) * tso - 1
    vertices[:, 2, 0] = (column + 1) * tso - 1
    vertices[:, 2, 1] = (row + 1) * tso - 1

    # per-pixel face id and barycentric weights (save_obj.py:37-70)
    ys, xs = np.mgrid[0:H, 0:W]
    fn = (xs // tso) + (ys // tso) * tile_width
    valid = fn < num_faces
    fnc = np.clip(fn, 0, num_faces - 1)
    finv = _face_inv(vertices[fnc, 0], vertices[fnc, 1], vertices[fnc, 2])
    w = (finv[..., 0] * xs[..., None] + finv[..., 1] * ys[..., None]
         + finv[..., 2])
    w = w / (w.sum(-1, keepdims=True) + eps)

    # 8-corner trilinear from the cube (save_obj.py:77-97)
    tif = np.clip(w * (tsi - 1), 0.0, tsi - 1 - eps)
    lo = tif.astype(np.int64)
    frac = tif - lo
    tex_flat = textures.reshape(num_faces, tsi * tsi * tsi, 3)
    out = np.zeros((H, W, 3), np.float32)
    for pn in range(8):
        wgt = np.ones((H, W), np.float32)
        ii = []
        for k in range(3):
            if (pn >> k) % 2 == 0:
                wgt = wgt * (1.0 - frac[..., k])
                ii.append(lo[..., k])
            else:
                wgt = wgt * frac[..., k]
                ii.append(lo[..., k] + 1)
        isc = ii[0] * tsi * tsi + ii[1] * tsi + ii[2]
        out += wgt[..., None] * tex_flat[fnc, isc]
    image = np.where(valid[..., None], out, 0.0)

    # seam fix (save_obj.py:109-140, K10): copy the pixel just left of the
    # tile diagonal across it
    seam = (ys % tso + 1) == (xs % tso)
    src = np.roll(image, 1, axis=1)
    image = np.where(seam[..., None], src, image)

    vertices[:, :, 0] /= (W - 1)
    vertices[:, :, 1] /= (H - 1)
    image = image[::-1, ::1]
    return image, vertices


def save_obj(filename, vertices, faces, textures=None):
    """Write an OBJ (+ MTL and PNG atlas when textures are given).

    Reference save_obj.py:151-192; arrays may be numpy arrays or tensors.
    """
    vertices, faces = (
        a.detach().cpu().numpy() if hasattr(a, 'detach') else np.asarray(a)
        for a in (vertices, faces))
    if vertices.ndim != 2 or faces.ndim != 2:
        raise ValueError('vertices must be [nv, 3] and faces [nf, 3]; got '
                         f'{vertices.shape} and {faces.shape}')

    filename_mtl = filename[:-4] + '.mtl'
    filename_texture = filename[:-4] + '.png'
    material_name = 'material_1'
    if textures is not None:
        texture_image, vertices_textures = create_texture_image(textures)
        imsave01(filename_texture, texture_image)

    with open(filename, 'w') as f:
        f.write('# %s\n' % os.path.basename(filename))
        f.write('#\n')
        f.write('\n')
        if textures is not None:
            f.write('mtllib %s\n\n' % os.path.basename(filename_mtl))
        for vertex in vertices:
            f.write('v %.8f %.8f %.8f\n' % (vertex[0], vertex[1], vertex[2]))
        f.write('\n')
        if textures is not None:
            for vertex in vertices_textures.reshape(-1, 2):
                f.write('vt %.8f %.8f\n' % (vertex[0], vertex[1]))
            f.write('\n')
            f.write('usemtl %s\n' % material_name)
            for i, face in enumerate(faces):
                f.write('f %d/%d %d/%d %d/%d\n' % (
                    face[0] + 1, 3 * i + 1, face[1] + 1, 3 * i + 2,
                    face[2] + 1, 3 * i + 3))
            f.write('\n')
        else:
            for face in faces:
                f.write('f %d %d %d\n' % (
                    face[0] + 1, face[1] + 1, face[2] + 1))

    if textures is not None:
        with open(filename_mtl, 'w') as f:
            f.write('newmtl %s\n' % material_name)
            f.write('map_Kd %s\n' % os.path.basename(filename_texture))
