"""What the port records: spans on ``torch.profiler``'s clock, and counts
of kernel launches and host waits.

``span(name)`` marks ``nr.<name>`` on the profiler's timeline while a
``torch.profiler`` session is active, and costs one flag test otherwise.
A span is the profiler's own fast record (``_RecordFunctionFast``, a
``cpu_op`` event on the host's timeline, nothing on the device's), not
``record_function`` (a ``user_annotation``, five to eight times the host
time a span).  The profiler takes the device's activity on the same
clock, so every idle gap of the card in a trace lies on the axis of the
spans.  The spans are the layer boundaries of a call:

  * ``nr.render``, ``nr.render_rgbad``, ``nr.render_silhouettes``,
    ``nr.render_depth``: a ``Renderer`` entry point, the root of a call;
  * ``nr.scene`` (``.gather``, ``.lighting``, ``.camera``): the pre-raster
    ops, ``.gather`` the per-face gather of the vertices;
  * ``nr.raster`` (``.bin_setup``, ``.shade``, ``.merge``, ``.composite``,
    ``.post``): the rasterizer's forward (and ``nr.raster.index``, the
    index kernel's launch, which ``tune`` makes);
  * ``nr.backward``, on the autograd engine's thread: a call's backward
    root, from the engine's reaching the entry point's output until the
    gradients of its inputs are made (``backward(None, ...)``), so the
    engine's own adds of gradients fall inside it; under it the port's
    backward nodes (``nr.backward`` again, with ``.k5``, ``.k7``, ``.k6``,
    ``.reduce``, ``.scatter``) and the nodes that plain-torch regions of
    the forward build, each node inside its region's span
    (``backward(leaf, ...)``): ``nr.backward.lighting`` (the lighting and
    fill_back of the texture cubes), ``nr.backward.camera`` (the camera
    transform) and ``nr.backward.post`` (the output pass's flip and pool);
  * ``nr.wait.<kind>.<site>``: one host wait (see ``wait``).

``COUNTS`` counts, since import or ``reset()``:

  * ``launch.<kernel>``: launches of each hand-written kernel
    (``forward_shaded``, ``forward_index``, ``bin_faces``, ``insweep``,
    ``outsweep``, ``face_reduce``, ``face_grad``, ``segment_sum``,
    ``composite_pool``, ``tex_scatter``), never a plain version's call;
  * ``wait.copy.<site>``: copies of host data to the card made inside a
    call, all by ``config.place``;
  * ``kept.<site>``: host values that ``config.place`` found already on the
    card, kept from an earlier copy of the same bytes, and handed back with
    no copy and no wait (its share at a site: ``kept.<site>`` over
    ``kept.<site>`` + ``wait.copy.<site>``);
  * ``wait.read.<site>``: host reads of a value on the card;
  * ``work.faces``, ``work.bin_pairs``, ``work.bin_cells``: what the
    binning (``forward_cuda.bin_setup``) was handed and made: faces
    (``bs * nf``, after fill_back), (tile, face) pairs, and the (tile,
    128-face chunk) cells its kernels scan, all known on the host without a
    further wait;
  * ``work.k6_cells``: the texture cells (``bs * nf * ts^3``) whose sums
    the per-face reduction (``backward_cuda.face_reduce``) expands from the
    K6 factors, wherever textures of ``ts`` > 0 get a gradient through it;
    none in a silhouette step or under no_grad.  A shape the host knows;
  * ``k6.in_reduce``: reductions on the card whose tile pass built the K6
    factors from the forward's maps (``backward_cuda.face_reduce`` with
    ``k6``): 1 a training step whose textures of ``ts <= 4`` get a
    gradient, 0 in a silhouette step, under no_grad or above ts 4;
  * ``k6.scatter``, ``work.k6_scatter_cells``: texture gradients on the
    card that took the 8-corner scatter (``texture.grad_textures``, cubes
    above ts 4, one ``launch.tex_scatter`` each) and the cells it writes
    (``bs * nf * ts^3``); none at ts <= 4, in a silhouette step or under
    no_grad.  A shape the host knows;
  * ``light.folded``: renders whose per-face light was applied where the
    cubes are read, in sampling and the texture scatter, and never
    multiplied into a cube (``api.rasterize_rgbad`` given a light for cubes
    above ts 4, as the ``Renderer`` gives one): 1 such a render, 0 at
    ts <= 4, for silhouettes and depth, and for lit cubes.  A shape the
    host knows, on either device.

The plain CPU paths count nothing else.
"""

import collections
import contextlib

import torch
import torch.autograd.profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = 'nr.'
COUNTS = collections.Counter()
# the one context every span returns while no profiler runs
_OFF = contextlib.nullcontext()


def span(name):
    """A context marking ``nr.<name>`` while a profiler runs."""
    # the profiler's own flag: entering a record while no profiler runs
    # costs tens of times more
    if torch.autograd.profiler._is_profiler_enabled:
        return _RecordFunctionFast(PREFIX + name)
    return _OFF


def _tensors(value):
    """The tensors of a tensor, or of a tuple, list or dict of them."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return []


def _opener(held, name):
    """A backward hook that enters ``name`` into ``held`` while a profiler
    runs, where no span is held yet."""
    def hook(*_):
        if not held and torch.autograd.profiler._is_profiler_enabled:
            rec = _RecordFunctionFast(name)
            rec.__enter__()
            held.append(rec)
    return hook


def _closer(held):
    """A backward hook that leaves the span ``held`` has, if any."""
    def hook(*_):
        if held:
            held.pop().__exit__(None, None, None)
    return hook


def _mark(node, name):
    """Run the backward node ``node`` inside a span ``name``."""
    held = []
    node.register_prehook(_opener(held, name))
    node.register_hook(_closer(held))


def backward(leaf, fn, *args):
    """``fn(*args)``, whose backward is marked on the autograd engine's
    thread while a profiler runs; with none (or no grad mode), only
    ``fn(*args)`` after one flag test.

    With ``leaf``, each backward node that ``fn`` builds (by its sequence
    number, so no node of another region) runs inside its own
    ``nr.backward.<leaf>``: a span by node, as the engine may run other
    regions' nodes between two of this region's.  With ``leaf`` None, a
    ``Renderer`` entry point's root: ``nr.backward`` opens as the engine
    reaches the gradient of an output and closes once the gradients of the
    tensor ``args`` that need one are all made (a multi-grad hook).  Those
    ``args`` go into ``fn`` through ``view_as``, a node that launches
    nothing, as a leaf takes no multi-grad hook under
    ``torch.autograd.grad``.  The hooks hold no tensor and launch
    nothing."""
    if not (torch.autograd.profiler._is_profiler_enabled
            and torch.is_grad_enabled()):
        return fn(*args)
    if leaf is not None:
        # the sequence numbers this thread gives the nodes ``fn`` builds
        first = torch._C._autograd._get_sequence_nr()
        out = fn(*args)
        last = torch._C._autograd._get_sequence_nr()
        name = f'{PREFIX}backward.{leaf}'
        seen = set()
        todo = [t.grad_fn for t in _tensors(out)]
        while todo:
            node = todo.pop()
            if node is None or node in seen or not (
                    first <= node._sequence_nr() < last):
                continue
            seen.add(node)
            _mark(node, name)
            todo.extend(n for n, _ in node.next_functions)
        return out
    args = [a.view_as(a) if isinstance(a, torch.Tensor) and a.requires_grad
            else a for a in args]
    out = fn(*args)
    inputs = [a for a in args
              if isinstance(a, torch.Tensor) and a.requires_grad]
    outs = [t for t in _tensors(out) if t.requires_grad]
    if inputs and outs:
        held = []
        for t in outs:
            # a tensor's hook runs before its node's: the root opens
            # before a region's span on the same node
            t.register_hook(_opener(held, PREFIX + 'backward'))
        handle = []

        def close(grads):
            if held:
                held.pop().__exit__(None, None, None)
            # the hook holds the inputs' nodes, which hold the hook: the
            # cycle goes with the step, not with the collector; a retained
            # graph's next backward opens no root it could not close
            held.append(None)
            handle.pop().remove()

        handle.append(torch.autograd.graph.register_multi_grad_hook(
            inputs, close))
    return out


def wait(kind, site):
    """Count one host wait, ``wait.<kind>.<site>`` (``kind``: 'copy' or
    'read'), and return its span; the caller waits inside it."""
    key = f'wait.{kind}.{site}'
    COUNTS[key] += 1
    return span(key)


def host_copy(site, value, device):
    """The span of putting ``value`` on ``device`` (a ``torch.device``): a
    ``wait('copy', site)`` where that copies host data to the card, else a
    no-op."""
    if device.type == 'cuda' and not (
            isinstance(value, torch.Tensor) and value.is_cuda):
        return wait('copy', site)
    return _OFF


def kept(site):
    """Count one host value found kept on the card, ``kept.<site>``."""
    COUNTS[f'kept.{site}'] += 1


def counts():
    """A snapshot of ``COUNTS`` as a dict."""
    return dict(COUNTS)


def reset():
    """Zero every count."""
    COUNTS.clear()
