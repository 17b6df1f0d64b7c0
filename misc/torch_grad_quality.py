"""Gradient-quality study with neural_renderer_torch.

Port of misc/grad_quality.py, the study behind docs/GRADIENT_QUALITY.md:
one triangle with a vertical left edge at pixel column 22, a 64^2
silhouette without anti-aliasing or perspective, and the vertex gradient
of loss = sign * image[32, px] at 8 pixels on both sides of the edge.  It
shows, with numbers, the two properties that set the paper's approximate
gradient apart from edge-only differentiable rasterizers:

  1. pixels far from any edge still propagate non-zero vertex gradients;
  2. the gradient follows the objective: at the outside pixel 12,
     "brighter" moves the edge toward it and "darker", which no edge
     motion can achieve, gives exactly zero.

    python misc/torch_grad_quality.py [--device cpu]

Runs on the card unless ``--device cpu`` is given, prints the table and
raises if a property fails; ``run(argv)`` returns (rows, the pixel-12
"brighter" gradient, the pixel-12 "darker" gradient), a row being (pixel,
max |grad|, d loss / d v0.x).
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))

import argparse

import numpy as np

import neural_renderer_torch as nt

# the triangle's left edge lies at pixel column 22; the sampled columns
# march left (outside) and right (inside) of it
EDGE = 22
PIXELS = (21, 18, 12, 4, 23, 28, 36, 44)


def build(device):
    """(renderer, vertices, faces): the 64^2 orthographic renderer without
    anti-aliasing and the one triangle, on ``device``."""
    renderer = nt.Renderer()
    renderer.image_size = 64
    renderer.anti_aliasing = False
    renderer.perspective = False
    renderer.light_intensity_ambient = 1.0
    renderer.light_intensity_directional = 0.0
    vertices = np.array([[[-0.3, 0.6, 1.], [-0.3, -0.6, 1.],
                          [0.6, 0.0, 1.]]], np.float32)
    faces = np.array([[[0, 1, 2]]], np.int32)
    vertices, faces, _ = nt.arrays_from_numpy(vertices, faces, None, device)
    return renderer, vertices, faces


def grad_at(renderer, vertices, faces, px, sign):
    """The vertex gradient [3, 3] of sign * image[32, px], as numpy."""
    v = vertices.clone().requires_grad_()
    image = renderer.render_silhouettes(v, faces)
    (sign * image[0, 32, px]).backward()
    return v.grad[0].cpu().numpy()


def run(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    renderer, vertices, faces = build(args.device)

    # an uncovered pixel can only get brighter (the edge moves out over
    # it), a covered one only darker (the edge retreats past it): the
    # gradient is one-sided by design (the diff_grad > 0 gate, reference
    # rasterize.py:647,717), so each side uses its achievable loss
    print(f'{"pixel":>6} {"where":>8} {"loss":>9} {"dist(px)":>9} '
          f'{"|grad|":>12} {"gx(v0)":>12}')
    rows = []
    for px in PIXELS:
        outside = px < EDGE
        g = grad_at(renderer, vertices, faces, px, -1.0 if outside else 1.0)
        rows.append((px, float(np.abs(g).max()), float(g[0, 0])))
        print(f'{px:>6} {"outside" if outside else "inside":>8} '
              f'{"brighter" if outside else "darker":>9} '
              f'{abs(px - EDGE):>9} {rows[-1][1]:>12.5f} {g[0, 0]:>12.5f}')
    if not all(r[1] > 0 for r in rows):
        raise RuntimeError('a distant pixel had zero gradient')

    # property 2 at the outside pixel 12: "brighter" pulls the edge toward
    # it; "darker" is unachievable by any edge motion and gives exactly
    # zero, so no vertex moves in vain
    g_brighter = grad_at(renderer, vertices, faces, 12, -1.0)
    g_darker = grad_at(renderer, vertices, faces, 12, 1.0)
    print('\npixel 12 (outside): d(loss)/d(v0.x) for "brighter" = '
          f'{g_brighter[0, 0]:+.5f}, for "darker" = {g_darker[0, 0]:+.5f}')
    if not (abs(g_brighter[0, 0]) > 0 and np.all(g_darker == 0)):
        raise RuntimeError('the gradient does not follow the objective')
    print('OK: non-zero gradients at every distance; direction follows '
          'the objective')
    return rows, g_brighter, g_darker


if __name__ == '__main__':
    run()
