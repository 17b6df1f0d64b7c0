"""What the port records: spans on ``torch.profiler``'s clock, and counts
of kernel launches and host waits.

``span(name)`` marks ``nr.<name>`` on the profiler's timeline while a
``torch.profiler`` session is active (``record_function``), and costs one
flag test otherwise.  The profiler takes the device's activity on the same
clock, so every idle gap of the card in a trace lies on the axis of the
spans.  The spans are the layer boundaries of a call:

  * ``nr.render``, ``nr.render_rgbad``, ``nr.render_silhouettes``,
    ``nr.render_depth``: a ``Renderer`` entry point, the root of a call;
  * ``nr.scene`` (``.gather``, ``.lighting``, ``.camera``): the pre-raster
    ops, ``.gather`` the per-face gather of the vertices;
  * ``nr.raster`` (``.bin_setup``, ``.shade``, ``.merge``, ``.composite``,
    ``.post``): the rasterizer's forward (and ``nr.raster.index``, the
    index kernel's launch, which ``tune`` makes);
  * ``nr.backward`` (``.k5``, ``.k7``, ``.k6``, ``.reduce``, ``.scatter``):
    the port's backward nodes, on the autograd engine's thread;
  * ``nr.wait.<kind>.<site>``: one host wait (see ``wait``).

``COUNTS`` counts, since import or ``reset()``:

  * ``launch.<kernel>``: launches of each hand-written kernel
    (``forward_shaded``, ``forward_index``, ``bin_faces``, ``insweep``,
    ``outsweep``, ``face_reduce``, ``face_grad``, ``segment_sum``,
    ``composite_pool``), never a plain version's call;
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
  * ``k6.scatter``, ``work.k6_scatter_rows``, ``work.k6_scatter_cells``:
    texture gradients on the card that took the 8-corner scatter
    (``texture.grad_textures``, cubes above ts 4), the corner rows each
    handed to the sort (``8 * bs * is^2``) and the cells it sums onto
    (``bs * nf * ts^3``); none at ts <= 4, in a silhouette step or under
    no_grad.  Shapes the host knows.

The plain CPU paths count nothing.
"""

import collections
import contextlib

import torch
import torch.autograd.profiler

PREFIX = 'nr.'
COUNTS = collections.Counter()
# the one context every span returns while no profiler runs
_OFF = contextlib.nullcontext()


def span(name):
    """A context marking ``nr.<name>`` while a profiler runs."""
    # the profiler's own flag: entering record_function while no profiler
    # runs costs tens of times more
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


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
