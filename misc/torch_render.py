"""Batch multi-view renderer for mesh datasets (ShapeNet-style), with
neural_renderer_torch.

Port of misc/render.py: renders every OBJ under a directory (searched
recursively, in sorted order) from a ring of ``-n`` azimuths at distance
``-d`` and elevation ``-e`` with a default ``Renderer`` at ``-is``
(anti-aliased), textures loaded from each OBJ's materials at ``-ts``, and
writes ``{relative path with os.sep -> _}_{view:02d}.png`` into ``-o``.

An OBJ without a ``mtllib`` line is rendered with white textures, as the
JAX script renders it.  Any other failure to load textures (no Pillow for a
JPEG map, a map that does not decode, a missing map file) raises: a white
render would hide it.

The views of one mesh are rendered as batches of up to ``MAX_VIEWS``, each
row with its own eye; the images are bit-equal to rendering one view per
call (the renderer treats batch rows independently).

    python misc/torch_render.py -i <dir-with-obj-subdirs> -o <out-dir> \\
        [-n 24] [-is 256] [-d 2.732] [-e 30] [-ts 2] [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``run(argv)`` returns
the paths of the PNGs it wrote.
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))

import argparse
import glob

import numpy as np
import torch

import neural_renderer_torch as nt
from neural_renderer_torch.io.image import imsave01
from neural_renderer_torch.io.obj import NoMaterialLibrary

# views of one mesh rendered per call
MAX_VIEWS = 32


def load_mesh(path, texture_size, device):
    """(vertices [1, nv, 3], faces [1, nf, 3], textures [1, nf, ts, ts, ts,
    3]) on ``device``: the OBJ's own textures, or white cubes where it
    names no material library."""
    try:
        vertices, faces, textures = nt.load_obj(
            path, load_texture=True, texture_size=texture_size)
    except NoMaterialLibrary:
        vertices, faces = nt.load_obj(path)
        textures = np.ones((faces.shape[0],) + (texture_size,) * 3 + (3,),
                           np.float32)
    return nt.arrays_from_numpy(vertices[None], faces[None], textures[None],
                                device)


def view_eyes(num_views, distance, elevation, device):
    """[num_views, 3] eyes at azimuths 0, 360 / n, ... (float32 math, as
    the JAX script computes each eye)."""
    azimuths = torch.as_tensor(np.linspace(0, 360, num_views, endpoint=False
                                           ).astype(np.float32),
                               device=device)
    return nt.get_points_from_angles(torch.full_like(azimuths, distance),
                                     torch.full_like(azimuths, elevation),
                                     azimuths)


def render_views(renderer, vertices, faces, textures, eyes):
    """The mesh (a batch of one) seen from each row of ``eyes`` [n, 3]:
    images [n, 3, is, is] as a numpy array, ``MAX_VIEWS`` rows per call."""
    images = []
    with torch.no_grad():
        for i in range(0, eyes.shape[0], MAX_VIEWS):
            renderer.eye = eyes[i:i + MAX_VIEWS]
            n = renderer.eye.shape[0]
            images.append(renderer.render(
                vertices.expand(n, -1, -1), faces.expand(n, -1, -1),
                textures.expand((n,) + textures.shape[1:])).cpu())
    return torch.cat(images).numpy()


def run(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--input_dir', type=str, required=True)
    parser.add_argument('-o', '--output_dir', type=str, required=True)
    parser.add_argument('-n', '--num_views', type=int, default=24)
    parser.add_argument('-is', '--image_size', type=int, default=256)
    parser.add_argument('-d', '--distance', type=float, default=2.732)
    parser.add_argument('-e', '--elevation', type=float, default=30.0)
    parser.add_argument('-ts', '--texture_size', type=int, default=2)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)

    renderer = nt.Renderer()
    renderer.image_size = args.image_size
    os.makedirs(args.output_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.input_dir, '**', '*.obj'),
                             recursive=True))
    written = []
    for path in paths:
        name = os.path.splitext(os.path.relpath(path, args.input_dir)
                                )[0].replace(os.sep, '_')
        vertices, faces, textures = load_mesh(path, args.texture_size,
                                              args.device)
        eyes = view_eyes(args.num_views, args.distance, args.elevation,
                         vertices.device)
        images = render_views(renderer, vertices, faces, textures, eyes)
        for vi, image in enumerate(images):
            written.append(os.path.join(args.output_dir,
                                        f'{name}_{vi:02d}.png'))
            imsave01(written[-1], image.transpose(1, 2, 0))
        print(name, flush=True)
    return written


if __name__ == '__main__':
    run()
