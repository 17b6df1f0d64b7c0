"""Minimal image I/O helpers (PIL-backed).

Stand-ins for the reference's scipy.misc.imread / imsave usage.  PIL is
imported inside each function, so the package imports (and loads OBJ meshes
without textures) where Pillow is not installed.
"""

import numpy as np


def imread(path):
    """Image file -> uint8 array, like scipy.misc.imread."""
    from PIL import Image
    return np.asarray(Image.open(path))


def imsave(path, array):
    """Save an array as an image (clipped to [0, 255] uint8)."""
    from PIL import Image
    array = np.asarray(array)
    if array.dtype != np.uint8:
        array = np.clip(array, 0, 255).astype(np.uint8)
    Image.fromarray(array).save(path)
