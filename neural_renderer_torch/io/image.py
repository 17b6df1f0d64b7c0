"""Minimal image I/O helpers (PIL-backed).

Stand-ins for the reference's scipy.misc.imread / imsave / toimage usage.
``imsave01`` maps float [0, 1] to uint8 like ``scipy.misc.toimage(x,
cmin=0, cmax=1)``.  Pillow (and imageio, for GIFs) is imported inside each
function, so the package imports (and loads OBJ meshes without textures)
where Pillow is not installed.
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


def imsave01(path, array):
    """Save a float array scaled from [0, 1] (clipped) to uint8."""
    array = np.asarray(array, np.float32)
    imsave(path, (np.clip(array, 0.0, 1.0) * 255.0).round().astype(np.uint8))


def make_gif(filenames, output_path, fps=12):
    """Assemble PNG frames into a GIF (replaces the reference's ImageMagick
    ``convert`` subprocess, examples/example1.py:57-58).

    Uses imageio when installed (better palette handling), else Pillow."""
    try:
        import imageio
    except ImportError:
        from PIL import Image
        frames = [Image.open(f).convert('P') for f in filenames]
        frames[0].save(output_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
        return
    frames = [imageio.v2.imread(f) for f in filenames]
    imageio.mimsave(output_path, frames, duration=1.0 / fps, loop=0)
