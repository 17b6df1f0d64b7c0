"""Host-side spatial face ordering (Morton / Z-order of face centroids).

Port of the JAX package's ``ops/spatial.py``: a one-time numpy sort that
gives neighbouring faces neighbouring ids from any viewpoint, a
preprocessing utility for pipelines that slice or shard face lists.  It
has no reference counterpart (the reference's per-thread face loop has no
locality preference, rasterize.py:300).  Rendering is unchanged except
where two faces of exactly equal depth fight for a pixel: the z-buffer's
first-wins rule follows list order (rasterize.py:334), so ties follow the
new order.  Hence ``Mesh(spatial_order=True)`` is opt-in.
"""

import numpy as np


def _morton3(q):
    """Interleave 3 x 10-bit coords into a 30-bit Morton code.  q: [n, 3]
    integer array with values in [0, 1024)."""

    def spread(x):
        x = x.astype(np.uint32)
        x = (x | (x << np.uint32(16))) & np.uint32(0x030000FF)
        x = (x | (x << np.uint32(8))) & np.uint32(0x0300F00F)
        x = (x | (x << np.uint32(4))) & np.uint32(0x030C30C3)
        x = (x | (x << np.uint32(2))) & np.uint32(0x09249249)
        return x

    x, y, z = (spread(q[:, i]) for i in range(3))
    return x | (y << np.uint32(1)) | (z << np.uint32(2))


def _numpy(a):
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(a, 'detach'):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def face_spatial_order(vertices, faces):
    """Permutation [nf] int32 ordering faces by the Morton code of their
    centroid (camera-independent 3D locality).

    vertices: [nv, 3]; faces: [nf, 3] int (numpy arrays or tensors).  Apply
    as ``faces[perm]`` (and ``textures[perm]`` to keep per-face data
    aligned).
    """
    v = _numpy(vertices).astype(np.float64)
    f = _numpy(faces).astype(np.int64)
    c = v[f].mean(axis=1)                       # [nf, 3] centroids
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip((c - lo) / span * 1023.0, 0.0, 1023.0).astype(np.uint32)
    return np.argsort(_morton3(q), kind='stable').astype(np.int32)


def spatial_sort(vertices, faces, textures=None):
    """Returns (faces[perm], textures[perm], perm) as numpy arrays.

    ``vertices`` are untouched by construction (the permutation only
    reorders faces and their per-face attributes).
    """
    perm = face_spatial_order(vertices, faces)
    f = _numpy(faces)[perm]
    t = None if textures is None else _numpy(textures)[perm]
    return f, t, perm
