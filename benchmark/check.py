"""What decides a run's ``correct``: the outputs the timed path produced,
held against the plain reference on the same inputs.

Each number compared is a largest gap, NaN counting as infinite:

* an image's (``image_err``; ``rgb_err``, ``alpha_err``, ``depth_err``
  for the three outputs of one raster): the largest absolute difference
  from the reference over every pixel of the sampled answers;
* a gradient's (``grad_vertices_err``, ``grad_textures_err``): the
  largest absolute difference over the reference's largest magnitude,
  over the sampled answers of each call.

A cell's limits are in ``limits/<cell>.json``; a run is correct when every
number is within its limit.  ``control`` is the reference in the place of
the program one precision below the configuration's float32: the camera,
the lighting and the gather computed in bfloat16 from bfloat16 inputs
(vertices, textures, eyes), the raster's pixel arithmetic in float32 (a
bfloat16 raster cannot even name the pixels of a row past 256), and its
outputs held in bfloat16.
"""

import json
import math
import pathlib

import torch

from benchmark import scene
from benchmark.reference import renderer as ref


def limits(cell, root=scene.ROOT.parent):
    """The limits of cell ``cell``: {number: limit}."""
    path = pathlib.Path(root) / 'benchmark' / 'limits' / f'{cell}.json'
    return json.loads(path.read_text())


def _gap(got, want, scale):
    diff = (got.double() - want.double()).abs()
    worst = float(torch.nan_to_num(diff, nan=math.inf).max())
    return worst / scale if scale > 0 else (0.0 if worst == 0 else math.inf)


def compare(images, grads, want_images, want_grads):
    """{number: gap} for one call's outputs against the reference's."""
    out = {}
    if isinstance(images, dict):
        for k, v in images.items():
            out[f'{k}_err'] = _gap(v, want_images[k], 1.0)
    else:
        out['image_err'] = _gap(images, want_images, 1.0)
    for k, g in grads.items():
        w = want_grads[k]
        out[f'grad_{k}_err'] = _gap(g, w, float(w.abs().max()))
    return out


def worst(readings):
    """The largest reading of each number over several calls."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(readings, lim):
    """(correct, [(name, value, limit)]): every number within its limit."""
    rows = [(k, readings[k], lim[k]) for k in sorted(lim)]
    missing = [k for k in lim if k not in readings]
    ok = not missing and all(v <= l for _, v, l in rows)
    return ok, rows


def control(cfg, entry, grads, vertices, faces, textures, eye, block):
    """The reference computed one precision below float32."""
    def low(x):
        return x.to(torch.bfloat16)

    images, g = ref.run(cfg, entry, grads, low(vertices), faces,
                        low(textures), low(eye), block,
                        raster_dtype=torch.float32)
    images = ({k: low(v).float() for k, v in images.items()}
              if isinstance(images, dict) else low(images).float())
    return images, {k: low(v).float() for k, v in g.items()}
