"""Example 4 with neural_renderer_torch: finding the camera position.

Port of examples/example4.py (reference examples/example4.py): fit the
camera position so that the teapot's silhouette matches a reference image.
The trainable parameter is a 3-vector eye tensor, set as ``renderer.eye``;
its gradient flows through ``look_at``, ``perspective`` and the
rasterizer's approximate backward, and the functional ``adam(alpha=0.1)``
updates it.  The fit stops once the loss drops below 70, within
``--num_steps``; each step writes a PNG frame of the rgb render, and the
frames become a GIF.  ``-mr 1`` first renders a new reference image from
azimuth -15, elevation 30.

    python examples/torch_example4.py [--device cpu] [-n STEPS] [-mr 1]

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
# the loss below which the fit stops (reference example4.py)
STOP_LOSS = 70


def make_reference_image(filename_ref, filename_obj, device):
    """Render the teapot (white textures under tanh) from azimuth -15,
    elevation 30 at 256^2 and save it as the reference image."""
    vertices, faces = nt.load_obj(filename_obj)
    vertices, faces, textures = nt.arrays_from_numpy(
        vertices[None], faces[None],
        np.ones((1, faces.shape[0], 2, 2, 2, 3), np.float32), device)
    renderer = nt.Renderer()
    renderer.eye = nt.get_points_from_angles(2.732, 30, -15)
    with torch.no_grad():
        images = renderer.render(vertices, faces, torch.tanh(textures))
    imsave01(filename_ref, images[0].permute(1, 2, 0).cpu().numpy())


def build(filename_obj, filename_ref, device):
    """(vertices, faces, textures, renderer, image_ref, camera_position):
    the teapot as a batch of one with white ts 2 textures on ``device``, a
    default ``Renderer`` at the reference image's size, the reference
    silhouette (its non-black pixels) and the starting eye [6, 10, -14],
    a leaf tensor that requires its gradient."""
    vertices, faces = nt.load_obj(filename_obj)
    vertices, faces, textures = nt.arrays_from_numpy(
        vertices[None], faces[None],
        np.ones((1, faces.shape[0], 2, 2, 2, 3), np.float32), device)
    image_ref = torch.as_tensor(
        (imread(filename_ref).max(-1) != 0).astype(np.float32),
        device=vertices.device)
    renderer = nt.Renderer()
    renderer.image_size = image_ref.shape[0]
    camera_position = torch.tensor([6.0, 10.0, -14.0], device=vertices.device,
                                   requires_grad=True)
    return vertices, faces, textures, renderer, image_ref, camera_position


def loss_fn(camera_position, renderer, vertices, faces, image_ref):
    renderer.eye = camera_position
    image = renderer.render_silhouettes(vertices, faces)
    return torch.sum(torch.square(image - image_ref[None]))


def step(camera_position, state, update_fn, renderer, vertices, faces,
         image_ref):
    """One step of the functional Adam on the eye, in place; returns (the
    loss before it, the new optimizer state)."""
    loss = loss_fn(camera_position, renderer, vertices, faces, image_ref)
    grad, = torch.autograd.grad(loss, camera_position)
    updates, state = update_fn({'eye': grad}, state)
    with torch.no_grad():
        camera_position.add_(updates['eye'])
    return float(loss.detach()), state


def run(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-io', '--filename_obj', type=str,
                        default=os.path.join(DATA, 'teapot.obj'))
    parser.add_argument('-ir', '--filename_ref', type=str,
                        default=os.path.join(DATA, 'example4_ref.png'))
    parser.add_argument('-or', '--filename_output', type=str,
                        default=os.path.join(DATA, 'example4_result.gif'))
    parser.add_argument('-mr', '--make_reference_image', type=int, default=0)
    parser.add_argument('-n', '--num_steps', type=int, default=1000)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    working_directory = os.path.dirname(args.filename_output)

    if args.make_reference_image:
        make_reference_image(args.filename_ref, args.filename_obj,
                             args.device)
    vertices, faces, textures, renderer, image_ref, camera_position = build(
        args.filename_obj, args.filename_ref, args.device)
    init_fn, update_fn = nt.adam(alpha=0.1)
    state = init_fn({'eye': camera_position})
    losses, frames = [], []
    for i in range(args.num_steps):
        loss, state = step(camera_position, state, update_fn, renderer,
                           vertices, faces, image_ref)
        losses.append(loss)
        with torch.no_grad():
            renderer.eye = camera_position
            images = renderer.render(vertices, faces, torch.tanh(textures))
        frames.append(os.path.join(working_directory, '_tmp_%04d.png' % i))
        imsave01(frames[-1], images[0].permute(1, 2, 0).cpu().numpy())
        if i % 10 == 0 or loss < STOP_LOSS:
            print(f'step {i}: loss {loss:.4f}', flush=True)
        if loss < STOP_LOSS:
            break
    make_gif(frames, args.filename_output)
    for f in frames:
        os.remove(f)
    return losses


if __name__ == '__main__':
    run()
