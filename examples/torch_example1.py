"""Example 1 with neural_renderer_torch: drawing a teapot from many
viewpoints.

Port of examples/example1.py (reference examples/example1.py): the teapot
with white ts 2 textures rendered by a default ``Renderer`` at 90 azimuths
(0, 4, ..., 356; distance 2.732, elevation 30), forward only, written as
PNG frames and assembled into a GIF.

    python examples/torch_example1.py [--device cpu] [-o OUT.gif]

Runs on the card unless ``--device cpu`` is given; ``run(argv)`` returns
the rendered images, [90, 3, 256, 256] float32.
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))

import argparse

import numpy as np
import torch

import neural_renderer_torch as nt
from neural_renderer_torch.io.image import imsave01, make_gif

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
CAMERA_DISTANCE = 2.732
ELEVATION = 30


def build(filename_obj, device):
    """(vertices, faces, textures, renderer): the teapot as a batch of one
    with white ts 2 textures on ``device``, and a default ``Renderer``."""
    vertices, faces = nt.load_obj(filename_obj)
    vertices, faces, textures = nt.arrays_from_numpy(
        vertices[None], faces[None],
        np.ones((1, faces.shape[0], 2, 2, 2, 3), np.float32), device)
    return vertices, faces, textures, nt.Renderer()


def render_sweep(renderer, vertices, faces, textures, azimuths):
    """The renders at ``azimuths`` (degrees) as a numpy array
    [len(azimuths), 3, is, is]."""
    images = []
    with torch.no_grad():
        for azimuth in azimuths:
            renderer.eye = nt.get_points_from_angles(
                np.float32(CAMERA_DISTANCE), np.float32(ELEVATION),
                np.float32(azimuth), device=vertices.device)
            images.append(renderer.render(vertices, faces, textures)[0].cpu())
    return torch.stack(images).numpy()


def run(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--filename_input', type=str,
                        default=os.path.join(DATA, 'teapot.obj'))
    parser.add_argument('-o', '--filename_output', type=str,
                        default=os.path.join(DATA, 'example1.gif'))
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    working_directory = os.path.dirname(args.filename_output)

    vertices, faces, textures, renderer = build(args.filename_input,
                                                args.device)
    images = render_sweep(renderer, vertices, faces, textures,
                          range(0, 360, 4))
    frames = []
    for num, image in enumerate(images):
        frames.append(os.path.join(working_directory, '_tmp_%04d.png' % num))
        imsave01(frames[-1], image.transpose(1, 2, 0))
    make_gif(frames, args.filename_output)
    for f in frames:
        os.remove(f)
    print(f'{len(frames)} frames -> {args.filename_output}', flush=True)
    return images


if __name__ == '__main__':
    run()
