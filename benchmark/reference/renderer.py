"""The reference ``Renderer``'s entry points in plain PyTorch, and a
function that runs them over a batch in blocks, with the gradients of the
images' sum.

``render`` (textured rgb), ``render_silhouettes`` (alpha) and
``render_rgbad`` (all three from one raster) follow the reference's
``renderer.py``: ``fill_back`` doubles the faces (and the texture cubes,
transposed), lighting is baked into the cubes from world-space faces, the
camera is ``look_at`` then ``perspective``, and the raster is drawn at
twice the size and pooled under anti-aliasing.  The rgb entries take the
renderer's ``rasterizer_eps``; silhouettes take the rasterizer's default
eps, as the reference passes none.
"""

import torch

from benchmark.reference import camera
from benchmark.reference import raster

DEFAULT_EPS = 1e-4
ENTRIES = ('render', 'render_silhouettes', 'render_rgbad')


def _transform(cfg, vertices, eye):
    v = camera.look_at(vertices, eye)
    return camera.perspective(v, cfg['viewing_angle'])


def render(cfg, entry, vertices, faces, textures, eye, raster_dtype=None):
    """One call of ``entry`` on ``[bs, nv, 3]`` vertices, int ``[bs, nf,
    3]`` faces, ``[bs, nf, ts, ts, ts, 3]`` textures and an eye ``[3]`` or
    ``[bs, 3]``: rgb ``[bs, 3, H, W]``, alpha ``[bs, H, W]`` or the dict of
    rgb, alpha and depth.  The camera and lighting compute in the inputs'
    dtype, the raster in ``raster_dtype`` (the same by default)."""
    if entry not in ENTRIES:
        raise ValueError(f'unknown entry {entry!r}')
    common = (cfg['image_size'], cfg['anti_aliasing'], cfg['near'],
              cfg['far'])
    f = camera.fill_back(faces) if cfg['fill_back'] else faces
    if entry == 'render_silhouettes':
        fc = camera.gather(_transform(cfg, vertices, eye), f)
        fc = fc if raster_dtype is None else fc.to(raster_dtype)
        return raster.rasterize(fc, None, *common, DEFAULT_EPS,
                                cfg['background_color'], ('alpha',))['alpha']
    if cfg['fill_back']:
        textures = camera.fill_back_textures(textures)
    world = camera.gather(vertices, f)
    textures = camera.lighting(world, textures)
    bs, nf = world.shape[:2]
    fc = _transform(cfg, world.reshape(bs, nf * 3, 3), eye).reshape(
        bs, nf, 3, 3)
    if raster_dtype is not None:
        fc, textures = fc.to(raster_dtype), textures.to(raster_dtype)
    outputs = ('rgb',) if entry == 'render' else ('rgb', 'alpha', 'depth')
    out = raster.rasterize(fc, textures, *common, cfg['rasterizer_eps'],
                           cfg['background_color'], outputs)
    return out['rgb'] if entry == 'render' else out


def run(cfg, entry, grads, vertices, faces, textures, eye, block,
        raster_dtype=None):
    """``entry`` over the batch in blocks of ``block`` elements, and the
    gradients of the images' sum with respect to the inputs named in
    ``grads`` ('vertices', 'textures'): (images, {name: gradient}).  Each
    element's image and gradients depend on that element alone, so blocks
    give what one call over the batch gives."""
    bs = vertices.shape[0]
    images, got = [], {g: [] for g in grads}
    for b0 in range(0, bs, block):
        sl = slice(b0, b0 + block)
        leaves = {'vertices': vertices[sl].detach(),
                  'textures': (None if textures is None
                               else textures[sl].detach())}
        for g in grads:
            leaves[g].requires_grad_(True)
        e = eye[sl] if eye.ndim == 2 else eye
        with torch.set_grad_enabled(bool(grads)):
            out = render(cfg, entry, leaves['vertices'], faces[sl],
                         leaves['textures'], e, raster_dtype)
        if grads:
            res = torch.autograd.grad(out.sum(), [leaves[g] for g in grads])
            for g, r in zip(grads, res):
                got[g].append(r)
        images.append({k: v.detach() for k, v in out.items()}
                      if isinstance(out, dict) else out.detach())
    if isinstance(images[0], dict):
        images = {k: torch.cat([i[k] for i in images]) for k in images[0]}
    else:
        images = torch.cat(images)
    return images, {g: torch.cat(v) for g, v in got.items()}


def raster_faces(cfg, entry, vertices, faces, eye):
    """The NDC face coordinates ``[bs, nf', 3, 3]`` the rasterizer of
    ``entry`` draws (after fill_back), without gradients."""
    with torch.no_grad():
        f = camera.fill_back(faces) if cfg['fill_back'] else faces
        return camera.gather(_transform(cfg, vertices, eye), f)


def raster_size(cfg):
    return cfg['image_size'] * (2 if cfg['anti_aliasing'] else 1)
