"""The benchmark's inputs: the mesh of a configuration, its textures and
eyes, made from the seed and handed alike to the program and to the plain
reference.

The OBJ is read here (``v`` and ``f`` lines, polygons fanned into
triangles) and normalised as the reference's ``load_obj`` does: into a
cube of side 2 centred at the origin.  Eyes follow the reference's
``get_points_from_angles``, in float32 on the host, and are then put on
the device.
"""

import pathlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent


def load_obj(path):
    """(vertices [nv, 3] float32, faces [nf, 3] int64), normalised."""
    vertices, faces = [], []
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == 'v':
            vertices.append([float(x) for x in parts[1:4]])
        elif parts[0] == 'f':
            n = len(vertices)
            idx = [int(p.split('/')[0]) for p in parts[1:]]
            idx = [i - 1 if i > 0 else n + i for i in idx]
            for k in range(len(idx) - 2):
                faces.append((idx[0], idx[k + 1], idx[k + 2]))
    v = np.asarray(vertices, np.float32)
    v = v - v.min(0)[None, :]
    v = v / np.abs(v).max()
    v = v * 2
    v = v - v.max(0)[None, :] / 2
    return v, np.asarray(faces, np.int64)


def eye_at(distance, elevation, azimuth):
    """The eye ``[3]`` (float32, host) at ``distance`` and the angles in
    degrees: ``(d cos e sin a, d sin e, -d cos e cos a)``."""
    d = torch.tensor(distance, dtype=torch.float32)
    e = torch.deg2rad(torch.tensor(elevation, dtype=torch.float32))
    a = torch.deg2rad(torch.tensor(azimuth, dtype=torch.float32))
    return torch.stack([d * torch.cos(e) * torch.sin(a), d * torch.sin(e),
                        -d * torch.cos(e) * torch.cos(a)])


def azimuths(spec):
    """Azimuths in degrees from a traffic's ``{"start", "stop", "count"}``:
    ``count`` evenly spaced from ``start``, ``stop`` left out."""
    step = (spec['stop'] - spec['start']) / spec['count']
    return [spec['start'] + step * i for i in range(spec['count'])]


def make(cfg, batch, seed, device):
    """(vertices [batch, nv, 3], faces [batch, nf, 3] int64, textures
    [batch, nf, ts, ts, ts, 3] or None) on ``device``: the mesh of
    ``cfg['mesh']`` for every batch element and textures uniform in
    [0, 1) from ``seed``, drawn on the device in one call."""
    v, f = load_obj(ROOT / cfg['mesh'])
    vertices = torch.as_tensor(v, device=device)[None].repeat(batch, 1, 1)
    faces = torch.as_tensor(f, device=device)[None].repeat(batch, 1, 1)
    ts = cfg['texture_size']
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    textures = torch.rand((batch, f.shape[0], ts, ts, ts, 3), generator=gen,
                          device=device)
    return vertices, faces, textures
