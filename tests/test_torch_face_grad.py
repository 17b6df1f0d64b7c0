"""The face gradient's assembly (``backward_cuda.face_grad``) on the CPU.

* The plain version (``face_grad_plain``), which the CPU route and the
  kernel's checks on the card share, equals the assembly the port ran
  before it (copied here as ``_seed_grad``: ``zeros(face_shape)``, plus the
  stacked K5 slots of ``sums[:, :12]``, plus the K7 columns) bit for bit,
  compared as int32 patterns, so NaNs and signed zeros count: row widths
  of 9 (K7 only), 12 (K5 only), 21 (K5 and K7), 36 (K5 and the K6 cells of
  ts 2), 45 (all three) and 0 (nothing drawn: zeros), sums holding -0, NaN
  of both signs and infinities, one face, odd sizes and no faces.
* ``RasterizeCore`` assembles its face gradient with one ``face_grad``
  call, which gives the seed's bits on the sums it is handed, for
  ``render``, ``render_silhouettes``, ``render_depth`` and
  ``render_rgbad`` with gradients, on the teapot and on an icosphere of
  subdivision 2.
* The wrapper rejects a wrong dtype, shape, term layout or device.
* With the card faked (``torch_fakes.fake_card``: ``on_card`` and ``_build``), a
  CPU tensor takes the launcher's route: a fake
  library stands in for ``csrc/face_reduce.cu`` and computes each entry
  with the kernel's own indexing over the raw buffers, and
  ``launch.face_grad`` counts each launch (none for no faces).

The kernel itself runs only on the card: ``chip_smoke.py`` holds it to
``face_grad_plain`` bit for bit.
"""

import ctypes
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import torch_fakes
import utils
from neural_renderer_torch import tracing
from neural_renderer_torch.rasterize import backward_cuda

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')

# row width -> (k5, k7_off): the layouts RasterizeCore hands over (none
# where nothing is drawn)
LAYOUTS = {0: (False, None), 9: (False, 0), 12: (True, None),
           21: (True, 12), 36: (True, None), 45: (True, 12)}
# (bs, nf): one face, odd sizes, a larger batch, no faces
SIZES = [(1, 1), (3, 7), (4, 331), (2, 0)]


def _seed_grad(sums, face_shape, k5, k7_off):
    """The face gradient as the port assembled it before ``face_grad``,
    verbatim: zeros, plus the K5 scatter's stack, plus the K7 columns."""
    bs, nf = face_shape[:2]
    grad_faces = torch.zeros(face_shape, dtype=torch.float32)
    if k5:
        ea = [(e, a) for a in range(2) for e in range(3)]
        cols = []
        for v in range(3):
            for c in range(2):
                ch0 = ea.index((v, 1 - c))
                ch1 = ea.index(((v + 2) % 3, 1 - c))
                cols.append(sums[:, 2 * ch0] + sums[:, 2 * ch1 + 1])
            cols.append(torch.zeros_like(cols[-1]))
        grad_faces = grad_faces + torch.stack(cols, dim=-1).reshape(
            bs, nf, 3, 3)
    if k7_off is not None:
        grad_faces = grad_faces + sums[:, k7_off:k7_off + 9].reshape(
            face_shape)
    return grad_faces


def _sums(seed, n, c_out, specials):
    """Normal values, with -0, NaN of both signs and infinities in about a
    quarter of the entries where ``specials``."""
    gen = torch.Generator().manual_seed(seed)
    sums = torch.randn((n, c_out), generator=gen)
    if specials:
        pick = torch.randint(0, 12, (n, c_out), generator=gen)
        for k, value in enumerate((-0.0, float('nan'), -float('nan'),
                                   float('inf'), -float('inf'))):
            sums[pick == k] = value
    return sums


def _bits_equal(got, want):
    assert got.shape == want.shape
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


@pytest.mark.parametrize('specials', [False, True])
@pytest.mark.parametrize('bs,nf', SIZES)
@pytest.mark.parametrize('c_out', sorted(LAYOUTS))
def test_plain_face_grad_equals_the_seed_assembly(c_out, bs, nf, specials):
    k5, k7_off = LAYOUTS[c_out]
    sums = _sums(c_out * 100 + nf, bs * nf, c_out, specials)
    face_shape = (bs, nf, 3, 3)
    got = backward_cuda.face_grad(sums, face_shape, k5, k7_off)
    _bits_equal(got, _seed_grad(sums, face_shape, k5, k7_off))
    assert got.is_contiguous()
    if specials and bs * nf > 1:
        # the leading add onto zeros turned every -0 into +0
        assert not bool(torch.signbit(got[got == 0]).any())


def _icosphere_scene():
    v, f = chip_smoke._icosphere(2)
    return torch.as_tensor(v, dtype=torch.float32), torch.as_tensor(
        f, dtype=torch.int64)


def _teapot_scene():
    v, f = nt.load_obj(TEAPOT)
    return torch.as_tensor(v), torch.as_tensor(f, dtype=torch.int64)


SCENES = {'teapot': _teapot_scene, 'icosphere2': _icosphere_scene}
# entry point -> (row width, k5, k7_off) of the sums it hands face_grad:
# textures ts 2 require a gradient where the entry point draws them
ENTRIES = {'render': (36, True, None), 'render_silhouettes': (12, True, None),
           'render_depth': (9, False, 0), 'render_rgbad': (45, True, 12)}


@pytest.mark.parametrize('entry', sorted(ENTRIES))
@pytest.mark.parametrize('mesh', sorted(SCENES))
def test_rasterize_core_face_gradient_is_the_seed_assembly(
        monkeypatch, mesh, entry):
    v, f = SCENES[mesh]()
    bs = 2
    v = v[None].expand(bs, -1, -1).contiguous()
    f = f[None].expand(bs, -1, -1)
    tx = torch.rand((bs, f.shape[1], 2, 2, 2, 3),
                    generator=torch.Generator().manual_seed(3))
    r = nt.Renderer()
    r.image_size = 16
    r.eye = torch.tensor([[0.0, 0.5, -2.7], [1.0, 1.0, -2.7]])

    calls = []

    def recorded(sums, face_shape, k5, k7_off=None):
        out = face_grad(sums, face_shape, k5, k7_off)
        calls.append((sums.clone(), tuple(face_shape), k5, k7_off, out))
        return out

    face_grad = backward_cuda.face_grad
    monkeypatch.setattr(backward_cuda, 'face_grad', recorded)
    v_in = v.clone().requires_grad_(True)
    tx_in = tx.clone().requires_grad_(True)
    if entry in ('render', 'render_rgbad'):
        out = getattr(r, entry)(v_in, f, tx_in)
        leaves = [v_in, tx_in]
    else:
        out = getattr(r, entry)(v_in, f)
        leaves = [v_in]
    if isinstance(out, dict):
        loss = out['rgb'].sum() + out['alpha'].sum() + out['depth'].sum()
    else:
        loss = out.sum()
    grads = torch.autograd.grad(loss, leaves)

    assert len(calls) == 1
    sums, face_shape, k5, k7_off, got = calls[0]
    c_out, want_k5, want_k7 = ENTRIES[entry]
    assert (sums.shape[1], k5, k7_off) == (c_out, want_k5, want_k7)
    assert face_shape[:2] == (bs, 2 * f.shape[1])  # fill_back doubles
    _bits_equal(got, _seed_grad(sums, face_shape, k5, k7_off))
    assert bool((got != 0).any())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert bool((grads[0] != 0).any())


GOOD = dict(sums=torch.zeros((6, 21)), face_shape=(2, 3, 3, 3), k5=True,
            k7_off=12)
BAD = {
    'float64': dict(sums=torch.zeros((6, 21), dtype=torch.float64)),
    'rows': dict(sums=torch.zeros((5, 21))),
    'too_few_columns_for_k7': dict(sums=torch.zeros((6, 20))),
    'too_few_columns_for_k5': dict(sums=torch.zeros((6, 9)), k7_off=None),
    'one_dimensional': dict(sums=torch.zeros(126)),
    'column_stride': dict(sums=torch.zeros((21, 6)).t()),
    'face_shape': dict(face_shape=(2, 3, 9)),
    'face_shape_vertices': dict(face_shape=(2, 3, 4, 3)),
    'negative_k7_off': dict(k7_off=-1),
    'device': dict(sums=torch.zeros((6, 21), device='meta')),
}


@pytest.mark.parametrize('case', sorted(BAD))
def test_face_grad_rejects_bad_inputs(case):
    backward_cuda.face_grad(**GOOD)
    with pytest.raises(ValueError):
        backward_cuda.face_grad(**dict(GOOD, **BAD[case]))


class _FakeReduce:
    """Stands in for ``csrc/face_reduce.cu``: ``nr_face_grad`` computes
    each entry as the kernel does, a thread's indexing and adds in order,
    over the raw buffers behind the pointers."""

    launches = 0

    @classmethod
    def nr_face_grad(cls, sums, row_stride, faces, k5, k7_off, out, stream):
        cls.launches += 1
        width = max(12 if k5 else 0, k7_off + 9 if k7_off >= 0 else 0)
        src = np.ctypeslib.as_array((ctypes.c_float * max(
            1, (faces - 1) * row_stride + width)).from_address(sums))
        dst = np.ctypeslib.as_array(
            (ctypes.c_float * (9 * faces)).from_address(out))
        zero = np.float32(0.0)
        for i in range(9 * faces):
            r, j = divmod(i, 9)
            v, c = divmod(j, 3)
            row = r * row_stride
            acc = zero
            if k5 and c < 2:
                ch0 = 3 * (1 - c) + v
                ch1 = 3 * (1 - c) + (v + 2) % 3
                acc = zero + (src[row + 2 * ch0] + src[row + 2 * ch1 + 1])
            if k7_off >= 0:
                acc = acc + src[row + k7_off + j]
            dst[i] = acc
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    _FakeReduce.launches = 0
    torch_fakes.fake_card(monkeypatch, backward_cuda, _FakeReduce)
    tracing.reset()
    yield
    tracing.reset()


# (row width of the tensor, columns handed over, bs, nf): the handed
# columns are a leading slice, so rows lie row width apart
ROUTE_CASES = [(12, 12, 3, 7), (21, 21, 1, 5), (9, 9, 2, 3),
               (45, 21, 2, 5), (36, 36, 1, 4), (12, 0, 2, 3),
               (12, 12, 2, 0)]


@pytest.mark.parametrize('width,cols,bs,nf', ROUTE_CASES)
def test_card_route_launches_once_and_counts(fake_card, width, cols, bs,
                                             nf):
    k5, k7_off = LAYOUTS[cols]
    full = _sums(width + nf, bs * nf, width, False)
    full[::3, 0] = -0.0
    sums = full[:, :cols]
    face_shape = (bs, nf, 3, 3)
    got = backward_cuda.face_grad(sums, face_shape, k5, k7_off)
    _bits_equal(got, backward_cuda.face_grad_plain(sums, face_shape, k5,
                                                   k7_off))
    launched = int(bs * nf > 0)
    assert _FakeReduce.launches == launched
    assert tracing.counts() == ({'launch.face_grad': 1} if launched else {})
