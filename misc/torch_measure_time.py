"""Wall-clock timing of neural_renderer_torch under the reference protocol.

Port of misc/measure_time.py, which follows the reference's own timing
script: the teapot tiled to ``-bs`` with white ts 2 textures, a default
``Renderer`` at ``-is`` (anti-aliased), and for each azimuth 0, 15, ...,
345 at distance 2.732 and elevation 30 one forward and one "backward"
sample, first as silhouettes, then textured.  The eyes are made before the
clock starts (as float32, the JAX script's ``get_points_from_angles`` of
``np.float32`` scalars) and put on the device.

A sample is the host clock around one call and a device synchronize (the
JAX script's ``_sync``).  "Backward" is, as in the JAX script, one call of
the forward plus the backward of ``sum(image)``: with respect to the
vertices for silhouettes, to the vertices and the textures when textured.
The first sample of each kind is dropped and the mean of the rest printed
in the JAX script's four lines.  ``-us`` is accepted and ignored, as
there.

    python misc/torch_measure_time.py [-i OBJ] [-bs 1] [-is 256] \\
        [--device cpu]

Runs on the card unless ``--device cpu`` is given (the plain versions).
``build(args)`` returns the four callables of an eye; ``run(argv)``
returns the four means in ms.
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))

import argparse
import time

import numpy as np
import torch

import neural_renderer_torch as nt
from neural_renderer_torch.rasterize.config import resolve_device

CAMERA_DISTANCE = 2.732
ELEVATION = 30
TEXTURE_SIZE = 2
AZIMUTHS = range(0, 360, 15)
# the printed lines' names, in the order of build's callables
KINDS = ('silhouette forward', 'silhouette backward', 'texture forward',
         'texture backward')


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--filename_input', type=str,
                        default=os.path.join(
                            os.path.dirname(os.path.abspath(__file__)),
                            '..', 'tests', 'data', 'teapot.obj'))
    parser.add_argument('-bs', '--batch_size', type=int, default=1)
    parser.add_argument('-is', '--image_size', type=int, default=256)
    parser.add_argument('-us', '--unsafe', type=int, default=0)  # no-op
    parser.add_argument('--device', type=str, default='cuda')
    return parser.parse_args(argv)


def eye_at(azimuth, device):
    """The eye at ``azimuth`` (float32 math on the CPU, then on
    ``device``), so that every device sees the same eye."""
    return nt.get_points_from_angles(
        np.float32(CAMERA_DISTANCE), np.float32(ELEVATION),
        np.float32(azimuth), device='cpu').to(device)


def build(args):
    """The four callables of an eye ``[3]`` on the device, in ``KINDS``'
    order: silhouettes ``[bs, is, is]``; the vertex gradient of their
    sum; rgb images ``[bs, 3, is, is]``; the vertex and texture gradients
    of their sum."""
    vertices, faces = nt.load_obj(args.filename_input)
    bs = args.batch_size
    vertices, faces, textures = nt.arrays_from_numpy(
        np.tile(vertices[None], (bs, 1, 1)), np.tile(faces[None], (bs, 1, 1)),
        np.ones((bs, faces.shape[0]) + (TEXTURE_SIZE,) * 3 + (3,),
                np.float32), args.device)
    renderer = nt.Renderer()
    renderer.image_size = args.image_size

    def silhouettes(v, eye):
        renderer.eye = eye
        return renderer.render_silhouettes(v, faces)

    def rgb(v, t, eye):
        renderer.eye = eye
        return renderer.render(v, faces, t)

    def fwd_sil(eye):
        with torch.no_grad():
            return silhouettes(vertices, eye)

    def bwd_sil(eye):
        v = vertices.detach().requires_grad_()
        return torch.autograd.grad(silhouettes(v, eye).sum(), [v])

    def fwd_rgb(eye):
        with torch.no_grad():
            return rgb(vertices, textures, eye)

    def bwd_rgb(eye):
        v = vertices.detach().requires_grad_()
        t = textures.detach().requires_grad_()
        return torch.autograd.grad(rgb(v, t, eye).sum(), [v, t])

    return fwd_sil, bwd_sil, fwd_rgb, bwd_rgb


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _seconds(fn, eye):
    """One sample: the host clock around ``fn(eye)`` and a synchronize."""
    t0 = time.perf_counter()
    fn(eye)
    _sync(eye.device)
    return time.perf_counter() - t0


def run(argv=None):
    args = parse_args(argv)
    calls = build(args)
    device = resolve_device(args.device)
    eyes = [eye_at(azimuth, device) for azimuth in AZIMUTHS]
    _sync(device)
    means = []
    for forward, backward in (calls[:2], calls[2:]):
        times = [[], []]
        for eye in eyes:
            times[0].append(_seconds(forward, eye))
            times[1].append(_seconds(backward, eye))
        means += [float(np.mean(t[1:])) * 1e3 for t in times]
    for kind, ms in zip(KINDS, means):
        print(f'{kind} time: {ms:.3f} ms', flush=True)
    return means


if __name__ == '__main__':
    run()
