"""Example 2 with neural_renderer_torch: optimizing vertices.

Port of examples/example2.py (reference examples/example2.py): fit the
teapot's vertices to a target silhouette.  A ``Mesh`` of the teapot at ts 2
with constant white textures, ``render_silhouettes``, an L2 loss and the
custom ``Adam`` over ``mesh.lr_scales()``; the textures get no gradient,
so ``Adam`` leaves them as they are.  300 steps, a PNG frame of the
silhouette after each and a GIF of them, then an rgb sweep of the fitted
mesh over 90 azimuths into a second GIF.

    python examples/torch_example2.py [--device cpu] [-n STEPS]

Runs on the card unless ``--device cpu`` is given; ``run(argv)`` returns
the loss of every step.  The render size is the reference image's.
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))

import argparse

import numpy as np
import torch

import neural_renderer_torch as nt
from neural_renderer_torch.io.image import imread, imsave01, make_gif

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')


def build(filename_obj, filename_ref, device):
    """(mesh, renderer, image_ref): the teapot with white ts 2 textures on
    ``device``, a default ``Renderer`` at the reference image's size looking
    from azimuth 90, and the reference silhouette (its RGB mean / 255)."""
    vertices, faces = nt.load_obj(filename_obj)
    textures = np.ones((faces.shape[0], 2, 2, 2, 3), np.float32)
    mesh = nt.Mesh(vertices, textures, faces, device=device)
    image_ref = torch.as_tensor(
        imread(filename_ref).astype(np.float32).mean(-1) / 255.0,
        device=mesh.vertices.device)
    renderer = nt.Renderer()
    renderer.image_size = image_ref.shape[0]
    renderer.eye = nt.get_points_from_angles(2.732, 0, 90)
    return mesh, renderer, image_ref


def loss_fn(mesh, renderer, image_ref):
    image = renderer.render_silhouettes(mesh.vertices[None], mesh.faces[None])
    return torch.sum(torch.square(image - image_ref[None]))


def step(mesh, renderer, image_ref, optimizer):
    """One Adam step; returns the loss before it."""
    optimizer.zero_grad()
    loss = loss_fn(mesh, renderer, image_ref)
    loss.backward()
    optimizer.step()
    return float(loss.detach())


def sweep(mesh, renderer, working_directory, filename_output):
    """The fitted mesh rendered in rgb at azimuths 0, 4, ..., 356, written
    as PNG frames and assembled into a GIF."""
    frames = []
    with torch.no_grad():
        for num, azimuth in enumerate(range(0, 360, 4)):
            renderer.eye = nt.get_points_from_angles(
                np.float32(2.732), np.float32(0), np.float32(azimuth),
                device=mesh.vertices.device)
            images = renderer.render(mesh.vertices[None], mesh.faces[None],
                                     mesh.textures[None])
            frames.append(os.path.join(working_directory,
                                       '_tmp_%04d.png' % num))
            imsave01(frames[-1], images[0].permute(1, 2, 0).cpu().numpy())
    make_gif(frames, filename_output)
    for f in frames:
        os.remove(f)


def run(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-io', '--filename_obj', type=str,
                        default=os.path.join(DATA, 'teapot.obj'))
    parser.add_argument('-ir', '--filename_ref', type=str,
                        default=os.path.join(DATA, 'example2_ref.png'))
    parser.add_argument('-oo', '--filename_output_optimization', type=str,
                        default=os.path.join(DATA,
                                             'example2_optimization.gif'))
    parser.add_argument('-or', '--filename_output_result', type=str,
                        default=os.path.join(DATA, 'example2_result.gif'))
    parser.add_argument('-n', '--num_steps', type=int, default=300)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    working_directory = os.path.dirname(args.filename_output_result)

    mesh, renderer, image_ref = build(args.filename_obj, args.filename_ref,
                                      args.device)
    optimizer = nt.Adam(mesh.lr_scales())
    losses, frames = [], []
    for i in range(args.num_steps):
        losses.append(step(mesh, renderer, image_ref, optimizer))
        if i % 10 == 0 or i + 1 == args.num_steps:
            print(f'step {i}: loss {losses[-1]:.4f}', flush=True)
        with torch.no_grad():
            image = renderer.render_silhouettes(mesh.vertices[None],
                                                mesh.faces[None])
        frames.append(os.path.join(working_directory, '_tmp_%04d.png' % i))
        imsave01(frames[-1], image[0].cpu().numpy())
    make_gif(frames, args.filename_output_optimization)
    for f in frames:
        os.remove(f)
    sweep(mesh, renderer, working_directory, args.filename_output_result)
    return losses


if __name__ == '__main__':
    run()
