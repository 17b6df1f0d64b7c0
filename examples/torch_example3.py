"""Example 3 with neural_renderer_torch: optimizing textures.

Port of examples/example3.py (reference examples/example3.py): fit the
teapot's ts 4 texture cubes, squashed by tanh and starting at zero (a black
render), to a target RGB image under a random azimuth each step.  The
vertices are frozen by ``Mesh.set_lr(0, 1)``; the renderer is orthographic
(``perspective=False``) with ambient light 1 and directional light 0; the
optimizer is ``Adam(alpha=0.1, beta1=0.5)``.  The azimuths are drawn from
``np.random.default_rng(--seed)``.  300 steps, then an rgb sweep of the
fitted mesh over 90 azimuths into a GIF.

The JAX example calls ``nr.tune`` over the azimuth ring first; the port's
kernels have no capacities and its ``Renderer`` reads no
``perf_overrides``, so there is nothing to tune and the call is dropped.

    python examples/torch_example3.py [--device cpu] [-n STEPS] [--seed N]

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
    """(mesh, renderer, image_ref): the teapot with zero ts 4 textures and
    frozen vertices on ``device``, the orthographic ambient-lit
    ``Renderer`` at the reference image's size, and the reference image
    [3, h, w] in [0, 1]."""
    vertices, faces = nt.load_obj(filename_obj)
    textures = np.zeros((faces.shape[0], 4, 4, 4, 3), np.float32)
    mesh = nt.Mesh(vertices, textures, faces, device=device).set_lr(0.0, 1.0)
    image_ref = torch.as_tensor(
        imread(filename_ref).astype(np.float32) / 255.0,
        device=mesh.vertices.device).permute(2, 0, 1)
    renderer = nt.Renderer()
    renderer.image_size = image_ref.shape[1]
    renderer.perspective = False
    renderer.light_intensity_directional = 0.0
    renderer.light_intensity_ambient = 1.0
    return mesh, renderer, image_ref


def eye_at(azimuth, device):
    """The eye at ``azimuth`` degrees, distance 2.732, elevation 0."""
    return nt.get_points_from_angles(np.float32(2.732), np.float32(0),
                                     np.float32(azimuth), device=device)


def loss_fn(mesh, renderer, image_ref, azimuth):
    renderer.eye = eye_at(azimuth, mesh.vertices.device)
    image = renderer.render(mesh.vertices[None], mesh.faces[None],
                            torch.tanh(mesh.textures)[None])
    return torch.sum(torch.square(image - image_ref[None]))


def step(mesh, renderer, image_ref, optimizer, azimuth):
    """One Adam step seen from ``azimuth``; returns the loss before it."""
    optimizer.zero_grad()
    loss = loss_fn(mesh, renderer, image_ref, azimuth)
    loss.backward()
    optimizer.step()
    return float(loss.detach())


def sweep(mesh, renderer, working_directory, filename_output):
    """The fitted mesh rendered at azimuths 0, 4, ..., 356, written as PNG
    frames and assembled into a GIF."""
    frames = []
    with torch.no_grad():
        for num, azimuth in enumerate(range(0, 360, 4)):
            renderer.eye = eye_at(azimuth, mesh.vertices.device)
            images = renderer.render(mesh.vertices[None], mesh.faces[None],
                                     torch.tanh(mesh.textures)[None])
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
                        default=os.path.join(DATA, 'example3_ref.png'))
    parser.add_argument('-or', '--filename_output', type=str,
                        default=os.path.join(DATA, 'example3_result.gif'))
    parser.add_argument('-n', '--num_steps', type=int, default=300)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    working_directory = os.path.dirname(args.filename_output)

    mesh, renderer, image_ref = build(args.filename_obj, args.filename_ref,
                                      args.device)
    optimizer = nt.Adam(mesh.lr_scales(), alpha=0.1, beta1=0.5)
    rng = np.random.default_rng(args.seed)
    losses = []
    for i in range(args.num_steps):
        losses.append(step(mesh, renderer, image_ref, optimizer,
                           rng.uniform(0, 360)))
        if i % 10 == 0 or i + 1 == args.num_steps:
            print(f'step {i}: loss {losses[-1]:.4f}', flush=True)
    sweep(mesh, renderer, working_directory, args.filename_output)
    return losses


if __name__ == '__main__':
    run()
