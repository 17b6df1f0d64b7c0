"""Camera, lighting and face gather of the Neural 3D Mesh Renderer, in plain
PyTorch.

Follows the reference (``hiroharu-kato/neural_renderer``: ``look_at.py``,
``perspective.py``, ``lighting.py``, ``cross.py``, ``vertices_to_faces.py``
and ``renderer.py``) operation for operation.  Every tensor it makes takes
the dtype of its inputs.  Gradients come from autograd of these plain
operations.
"""

import torch

# chainer.functions.normalize: x / (||x|| + eps)
NORMALIZE_EPS = 1e-5


def cross(a, b):
    """Row-wise cross product of ``[..., 3]`` tensors."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def normalize(x):
    """x / (||x|| + eps) along the last axis; the gradient at a zero vector
    is chainer's limit (the square root is kept off 0)."""
    sumsq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    positive = sumsq > 0
    safe = torch.where(positive, sumsq, torch.ones_like(sumsq))
    norm = torch.where(positive, torch.sqrt(safe), torch.zeros_like(sumsq))
    return x / (norm + NORMALIZE_EPS)


def _vec3(v, like):
    """``v`` ([3] or [bs, 3]) as a [bs, 3] tensor beside ``like``
    ([bs, ...])."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v[None, :].expand(like.shape[0], 3) if v.ndim == 1 else v


def look_at(vertices, eye):
    """World ``[bs, nv, 3]`` -> camera space, looking from ``eye`` at the
    origin with +y up (reference look_at.py)."""
    eye = _vec3(eye, vertices)
    at = torch.zeros_like(eye)
    up = _vec3([0.0, 1.0, 0.0], vertices)
    z_axis = normalize(at - eye)
    x_axis = normalize(cross(up, z_axis))
    y_axis = normalize(cross(z_axis, x_axis))
    v = vertices - eye[:, None, :]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([v0 * r[:, None, 0] + v1 * r[:, None, 1]
                        + v2 * r[:, None, 2]
                        for r in (x_axis, y_axis, z_axis)], dim=-1)


def perspective(vertices, angle):
    """x / (z tan(angle)), y likewise, z kept; the angle in degrees turned
    to radians with the reference's literal 3.1416 (perspective.py)."""
    a = torch.as_tensor(angle, dtype=vertices.dtype, device=vertices.device)
    width = torch.tan(a / 180.0 * 3.1416)
    width = width.reshape(-1, 1).expand(vertices.shape[:2])
    z = vertices[:, :, 2]
    return torch.stack([vertices[:, :, 0] / z / width,
                        vertices[:, :, 1] / z / width, z], dim=2)


def fill_back(faces):
    """Each face followed, after all of them, by its reversed copy."""
    return torch.cat([faces, torch.flip(faces, dims=[2])], dim=1)


def fill_back_textures(textures):
    return torch.cat([textures, textures.permute(0, 1, 4, 3, 2, 5)], dim=1)


def gather(vertices, faces):
    """``[bs, nv, 3]`` and int ``[bs, nf, 3]`` -> ``[bs, nf, 3, 3]``
    (reference vertices_to_faces.py: one flat gather)."""
    bs, nv = vertices.shape[:2]
    offsets = (torch.arange(bs, device=faces.device) * nv)[:, None, None]
    flat = (faces.long() + offsets).reshape(-1)
    out = vertices.reshape(bs * nv, 3).index_select(0, flat)
    return out.reshape(bs, faces.shape[1], 3, 3)


def lighting(faces, textures, ambient=0.5, directional=0.5,
             direction=(0.0, 1.0, 0.0)):
    """Ambient plus directional white light per face, baked into the
    texture cubes (reference lighting.py)."""
    bs, nf = faces.shape[:2]
    light = torch.zeros((bs, nf, 3), dtype=faces.dtype, device=faces.device)
    light = light + ambient * _vec3([1.0, 1.0, 1.0], faces)[:, None, :]
    normals = normalize(cross(faces[:, :, 0] - faces[:, :, 1],
                              faces[:, :, 2] - faces[:, :, 1]))
    dot = torch.sum(normals * _vec3(direction, faces)[:, None, :], dim=2)
    cos = torch.maximum(dot, dot.new_zeros(()))
    light = light + (directional * _vec3([1.0, 1.0, 1.0], faces)[:, None, :]
                     * cos[:, :, None])
    return textures * light[:, :, None, None, None, :]
