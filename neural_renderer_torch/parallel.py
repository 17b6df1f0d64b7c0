"""Data and face-axis parallelism over ``torch.distributed`` process groups.

The counterpart of the JAX package's ``parallel.py``, in PyTorch's idiom:
one process per rank, each holding its own tensors, and collectives over an
explicit process group where the JAX package names a mesh axis.  Two axes:

* **batch** (data parallel): rendering is batch-parallel with no
  communication (``shard_batch``, ``make_sharded_render``); a training step
  averages the gradients and the loss over the group with ``all_reduce``
  (``make_data_parallel_train_step``).
* **faces** (model parallel, for meshes too large for one card): the face
  list and its texture cubes are sharded over the group (``shard_faces``),
  each rank rasterizes its slice, and the z-buffers merge by the
  lexicographic (depth, global id) minimum, which reproduces the
  reference's first-wins rule over the concatenated list exactly
  (``rasterize/core._merge_face_group``).  Each rank's backward reduces its
  own slice; the vertex gradient is summed over the group
  (``ops/vertices_to_faces``).

The two compose on a 2-D layout of ranks: a face group and a batch group
per rank (``make_face_sharded_render(..., batch_group=...)``).  Every
function takes its process groups explicitly and never initializes one;
tensors stay on the caller's device (the card by default).  A gloo group
takes CUDA tensors through the host (``_collectives.all_reduce``).
"""

import copy

import torch
import torch.distributed as dist

from neural_renderer_torch._collectives import all_reduce

MODES = ('rgb', 'silhouettes', 'depth', 'rgbad')


def _rank_slice(group, n):
    """This rank's ``slice`` of ``n`` items split evenly over ``group``."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % size:
        raise ValueError(f'{n} items do not split evenly over {size} ranks')
    step = n // size
    return slice(rank * step, (rank + 1) * step)


def shard_batch(group, *tensors):
    """Each tensor's slice of its leading (batch) axis for this rank of
    ``group``; the batch must split evenly.  One tensor in, one out."""
    out = tuple(t[_rank_slice(group, t.shape[0])] for t in tensors)
    return out[0] if len(out) == 1 else out


def _render_fn(renderer, mode):
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}; got {mode!r}')
    return {'rgb': renderer.render, 'rgbad': renderer.render_rgbad,
            'silhouettes': renderer.render_silhouettes,
            'depth': renderer.render_depth}[mode]


def make_sharded_render(renderer, group, mode='rgb'):
    """A batch-parallel render: ``f(vertices, faces[, textures])`` takes
    the whole batch, renders this rank's slice of it (``shard_batch``) and
    returns that slice's images; no communication.  ``mode``: 'rgb' |
    'silhouettes' | 'depth' | 'rgbad' (``render_rgbad``'s dict).  The
    renderer's attributes are read at each call."""
    fn = _render_fn(renderer, mode)

    def f(vertices, faces, textures=None):
        vertices, faces = shard_batch(group, vertices, faces)
        if mode in ('rgb', 'rgbad'):
            return fn(vertices, faces, shard_batch(group, textures))
        return fn(vertices, faces)

    return f


def sharded_render(renderer, group, vertices, faces, textures=None,
                   mode='rgb'):
    """One call of ``make_sharded_render(renderer, group, mode)``."""
    return make_sharded_render(renderer, group, mode)(vertices, faces,
                                                      textures)


def shard_faces(group, faces, textures=None, pad_face=None):
    """This rank's slice of the face axis (1) of ``faces [bs, nf, 3]`` (and
    of per-face ``textures [bs, nf, ...]``), nf padded up to a multiple of
    the group's size with degenerate faces (repeats of ``pad_face``, else
    of vertex 0) that rasterize to nothing, and zero texture cubes.
    Returns the faces' slice, or (faces' slice, textures' slice)."""
    size = dist.get_world_size(group)
    pad = (-faces.shape[1]) % size
    if pad:
        fill = (torch.zeros(3, dtype=faces.dtype, device=faces.device)
                if pad_face is None else
                torch.as_tensor(pad_face, dtype=faces.dtype,
                                device=faces.device))
        faces = torch.cat([faces, fill.reshape(1, 1, 3).expand(
            faces.shape[0], pad, 3)], dim=1)
        if textures is not None:
            textures = torch.cat([textures, textures.new_zeros(
                (textures.shape[0], pad) + tuple(textures.shape[2:]))], dim=1)
    part = _rank_slice(group, faces.shape[1])
    if textures is None:
        return faces[:, part]
    return faces[:, part], textures[:, part]


def make_face_sharded_render(renderer, group, mode='rgb', batch_group=None):
    """A face-sharded render: ``f(vertices, faces[, textures])`` with the
    whole vertex table and this rank's slice of the faces (and textures)
    from ``shard_faces(group, ...)``.  Each rank rasterizes its slice, the
    z-buffers merge across ``group`` (``RasterizeSettings.face_group``) and
    every rank of the group returns the same images; the vertex gradient
    is summed over ``group``.

    The render is exact for the shard-order face list, the concatenation of
    the ranks' slices.  ``fill_back`` doubles each slice in place, so the
    one-process list it equals is the concatenation of each slice followed
    by its reversed copy (as in the JAX package).

    ``batch_group``: on a 2-D layout of ranks, the group over which the
    batch is split; ``f`` then takes the whole batch and renders this
    rank's slice of it (``shard_batch``).  Works on a copy of ``renderer``
    made now."""
    r = copy.copy(renderer)
    r.face_group = group
    fn = _render_fn(r, mode)

    def f(vertices, faces, textures=None):
        if batch_group is not None:
            vertices, faces = shard_batch(batch_group, vertices, faces)
            if textures is not None:
                textures = shard_batch(batch_group, textures)
        if mode in ('rgb', 'rgbad'):
            return fn(vertices, faces, textures)
        return fn(vertices, faces)

    return f


def make_data_parallel_train_step(loss_fn, opt_update, group):
    """A data-parallel training step over ``group``.

    ``loss_fn(params, batch)`` -> scalar loss of this rank's batch slice
    (its mean over the slice, so the group's mean is the whole batch's);
    ``opt_update(grads, opt_state)`` -> (updates, new state), as
    ``optim.adam``'s ``update_fn``.  Returns ``step(params, opt_state,
    batch)`` -> (params, opt_state, loss): a local backward, an
    ``all_reduce`` mean of the gradients and of the loss over the group,
    and the update added to the params.  ``params`` is a dict of tensors,
    the same on every rank, which then stay the same."""
    size = dist.get_world_size(group)

    def step(params, opt_state, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        flat = torch.cat([
            (torch.zeros_like(p) if g is None else g).reshape(-1)
            for p, g in zip(leaves.values(), grads)]
            + [loss.detach().reshape(1)])
        flat = all_reduce(flat, dist.ReduceOp.SUM, group) / size
        mean, off = {}, 0
        for k, p in leaves.items():
            mean[k] = flat[off:off + p.numel()].reshape(p.shape)
            off += p.numel()
        updates, opt_state = opt_update(mean, opt_state)
        params = {k: params[k].detach() + updates[k] for k in params}
        return params, opt_state, flat[-1]

    return step
