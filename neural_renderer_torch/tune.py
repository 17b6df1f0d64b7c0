"""Per-scene measurement: the capacities a scene needs, and ``tune``.

Counterpart of the JAX package's ``tune.py``.  There, the rasterizer's
performance knobs (``faces_per_tile_cap``, ``grad_out_cap``,
``grad_offset_radius``, ``grad_csr_rows``, ``grad_row_cap``,
``forward_chunk_budget``) are exact only when they cover the scene, and
``tune`` measures the worst case over camera poses and records covering
values in ``renderer.perf_overrides``.

No kernel of the port has a capacity: each loops over any face list, any
crossing count and any face run, so every render is exact with no knob
set.  ``measure_scene`` and ``tune`` still give the JAX package's numbers
for the same scene, the same integers, so a scene can be sized for either
package, and they describe a scene's work (faces per patch, active
crossings).  ``tune`` records its dict in ``renderer.perf_overrides``,
which nothing in the port reads.

Typical use::

    renderer = nt.Renderer()
    nt.tune(renderer, vertices, faces,
            eyes=[nt.get_points_from_angles(2.732, 30, a)
                  for a in range(0, 360, 15)])
"""

import warnings

import torch

from neural_renderer_torch.ops.vertices_to_faces import vertices_to_faces
from neural_renderer_torch.rasterize import backward, forward_cuda
from neural_renderer_torch.rasterize.config import RasterizeSettings, place

# the JAX package's default per-row out-sweep capacity
# (RasterizeSettings.grad_row_cap there)
_JAX_GRAD_ROW_CAP = 256

# the out-sweep capacities of the JAX package, from backward.out_sweep_stats
_OUT_SWEEP_NEEDS = ('out_crossings', 'row_crossings', 'out_offset')


def measure_scene(settings, face_coords):
    """The capacities one NDC scene ``[bs, nf, 3, 3]`` needs in the JAX
    package, as a dict of ints: ``out_crossings`` (grad_out_cap),
    ``row_crossings`` (per row, grad_row_cap), ``out_offset``
    (grad_offset_radius - 1, a float holding an integer), ``binned_faces``
    (faces_per_tile_cap) and, for nf <= 16,384, ``csr_rows``
    (grad_csr_rows).

    The face-index map comes from ``forward_cuda.forward_face_index_map``,
    the port's index kernel on a CUDA tensor.  The JAX package reads it
    from its XLA oracle instead, because its Pallas forward has a capacity
    that could bias the measurement; the port's kernel has none, and its
    map equals the oracle's."""
    fim = forward_cuda.forward_face_index_map(settings, face_coords)[0]
    stats = backward.out_sweep_stats(settings, face_coords, fim)
    out = {k: stats[k] for k in _OUT_SWEEP_NEEDS}
    out['binned_faces'] = forward_cuda.binning_overflow(settings, face_coords)
    if face_coords.shape[1] <= forward_cuda.slice_size():
        out['csr_rows'] = forward_cuda.csr_rows_needed(settings, face_coords)
    return out


def tune(renderer, vertices, faces, eyes=None, margin=1.25, textures=None,
         measure=False, measure_iters=8):
    """Measure ``renderer``'s workload on a scene over camera poses and set
    ``renderer.perf_overrides`` to the JAX package's covering capacities.

    Args, defaults and the returned dict are the JAX package's
    (``neural_renderer_tpu.tune``):
      renderer: a ``Renderer`` whose camera and image settings to honour.
      vertices: ``[nv, 3]`` or ``[bs, nv, 3]`` vertex positions (a non-tensor
        lands on the card, ``config.resolve_device``).
      faces: matching int faces ``[nf, 3]`` or ``[bs, nf, 3]``.
      eyes: camera positions to cover (each anything ``renderer.eye``
        accepts); None = the renderer's current eye.
      margin: multiplier on the measured needs before rounding up.
      textures: the cubes the JAX package's ``measure=True`` probe renders
        with; unused here.
      measure: the JAX package times one step under the tuned capacities
        against the default and installs them only if they win.  In the
        port both are the same program (it has no capacity knobs), so the
        tuned step cannot win: both measuring phases run, a warning says
        why, the renderer is left untouched and ``{}`` is returned, the JAX
        package's own outcome when the default wins.
      measure_iters: the JAX probe's timed steps; unused here.

    Returns the capacity dict (also recorded in ``renderer.perf_overrides``),
    or ``{}`` with ``measure=True``.  ``renderer.eye`` is restored.
    """
    del textures, measure_iters
    vertices = place(vertices, site='tune.vertices')
    faces = place(faces, vertices.device, torch.int64, site='tune.faces')
    if vertices.ndim == 2:
        vertices = vertices[None]
    if faces.ndim == 2:
        faces = faces[None]
    if renderer.fill_back:
        faces = renderer._fill_back_faces(faces)

    # anti_aliasing=True renders everything at 2x; 'approx' renders the
    # value at 2x and the differentiable pass (where the backward's
    # capacities live) at 1x: the binning is measured at every size in
    # play, the backward at the size the backward runs
    aa = renderer.anti_aliasing
    value_size = renderer.image_size * (2 if aa else 1)
    grad_size = renderer.image_size if aa == 'approx' else value_size
    sizes = sorted({value_size, grad_size})

    def make_settings(size):
        return RasterizeSettings(
            image_size=size, near=float(renderer.near),
            far=float(renderer.far), return_rgb=False, return_alpha=True,
            return_depth=False)

    settings = make_settings(grad_size)
    saved_eye = renderer.eye
    if eyes is None:
        eyes = [saved_eye]

    def coords(eye):
        renderer.eye = eye
        return vertices_to_faces(renderer._transform(vertices), faces)

    worst = dict(binned_faces=0, out_crossings=0, row_crossings=0,
                 out_offset=0, csr_rows=0, chunks=0)

    def keep(name, value):
        worst[name] = max(worst[name], int(value))

    use_csr = faces.shape[1] <= forward_cuda.slice_size()
    try:
        with torch.no_grad():
            # phase 1: the binning capacity, at every render size
            for eye in eyes:
                fc = coords(eye)
                for size in sizes:
                    keep('binned_faces', forward_cuda.binning_overflow(
                        make_settings(size), fc))

            # phase 2: the backward's capacities from the face-index map,
            # and the chunk and CSR counts under the capacity phase 1 found
            # (the JAX package's counts clamp at it)
            cap = max(128, -(-worst['binned_faces'] // 128) * 128)
            for eye in eyes:
                fc = coords(eye)
                fim = forward_cuda.forward_face_index_map(settings, fc)[0]
                stats = backward.out_sweep_stats(settings, fc, fim)
                for name in _OUT_SWEEP_NEEDS:
                    keep(name, stats[name])
                if use_csr:
                    keep('csr_rows', forward_cuda.csr_rows_needed(
                        settings, fc, cap))
                for size in sizes:
                    keep('chunks', forward_cuda.chunks_needed(
                        make_settings(size), fc, cap))
    finally:
        renderer.eye = saved_eye

    def up(v, unit):
        return max(unit, -(-int(v * margin) // unit) * unit)

    overrides = dict(
        faces_per_tile_cap=up(worst['binned_faces'], 128),
        grad_out_cap=up(worst['out_crossings'], 1024),
        grad_offset_radius=worst['out_offset'] + 1,
        forward_chunk_budget=up(worst['chunks'], 64),
    )
    if worst['csr_rows']:
        overrides['grad_csr_rows'] = max(256, up(worst['csr_rows'], 128))
    if worst['row_crossings'] > _JAX_GRAD_ROW_CAP:
        overrides['grad_row_cap'] = up(worst['row_crossings'], 64)

    if measure:
        warnings.warn(
            'neural_renderer_torch.tune: measure=True compares a step under '
            'the tuned capacities with the default one, but the port has no '
            'capacity knobs, so the two are the same program; leaving the '
            'renderer untuned.')
        return {}

    renderer.perf_overrides = dict(renderer.perf_overrides, **overrides)
    return overrides
