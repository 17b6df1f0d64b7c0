"""The port's entry points run on the card unless asked for the CPU.

Non-tensor inputs, ``Mesh`` parameters and ``convert``'s tensors go to the
CUDA device by default.  Where torch has no card (``torch.cuda.
is_available`` is made False here, whatever the machine) the defaults raise
a clear error instead of handing back CPU tensors; ``device='cpu'`` and CPU
tensors keep working on the CPU.
"""

import os

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
import utils
from neural_renderer_torch.rasterize.config import as_tensors, place

TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')
NO_CARD = 'no CUDA device'


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _mesh():
    v = np.array([[0.5, 0.5, 1.], [-0.5, -0.5, 1.], [0.5, -0.5, 1.]],
                 np.float32)
    f = np.array([[0, 1, 2]], np.int64)
    t = np.zeros((1, 2, 2, 2, 3), np.float32)
    return v, t, f


@pytest.mark.parametrize('entry', [
    'arrays_from_numpy', 'render_silhouettes', 'render', 'rasterize',
    'Mesh', 'Mesh.from_obj', 'mesh_from_jax', 'renderer_from_jax', 'tune',
    'get_points_from_angles', 'cross'])
def test_default_device_raises_without_a_card(no_card, entry):
    v, t, f = _mesh()
    calls = {
        'arrays_from_numpy': lambda: nt.arrays_from_numpy(v, f),
        'render_silhouettes': lambda: nt.Renderer().render_silhouettes(
            v[None], f[None]),
        'render': lambda: nt.Renderer().render(v[None], f[None], t[None]),
        'rasterize': lambda: nt.rasterize(v[None, None].repeat(3, 2),
                                          t[None]),
        'Mesh': lambda: nt.Mesh(v, t, f),
        'Mesh.from_obj': lambda: nt.Mesh.from_obj(TEAPOT),
        'mesh_from_jax': lambda: nt.mesh_from_jax(nr.Mesh(v, t, f)),
        'renderer_from_jax': lambda: nt.renderer_from_jax(nr.Renderer()),
        'tune': lambda: nt.tune(nt.Renderer(), v, f),
        'get_points_from_angles': lambda: nt.get_points_from_angles(
            np.float32(2.732), np.float32(30.), np.float32(45.)),
        'cross': lambda: nt.cross(v[0], v[1]),
    }
    with pytest.raises(RuntimeError, match=NO_CARD):
        calls[entry]()


def test_cpu_when_asked(no_card):
    """``device='cpu'`` and CPU tensors stay on the CPU."""
    v, t, f = _mesh()
    vt, ft, tt = nt.arrays_from_numpy(v[None], f[None], t[None],
                                      device='cpu')
    assert {x.device.type for x in (vt, ft, tt)} == {'cpu'}
    mesh = nt.Mesh(v, t, f, device='cpu')
    assert {p.device.type for p in (mesh.vertices, mesh.textures,
                                    mesh.faces)} == {'cpu'}
    r = nt.renderer_from_jax(nr.Renderer(), device='cpu')
    r.image_size = 16
    sil = r.render_silhouettes(vt, ft)
    assert sil.device.type == 'cpu' and float(sil.max()) == 1.0
    az = np.array([0., 45.], np.float32)
    eyes = nt.get_points_from_angles(az + 2.732, az + 30., az, device='cpu')
    assert eyes.device.type == 'cpu' and eyes.shape == (2, 3)
    # a non-tensor operand lands beside the tensor one
    assert nt.cross(torch.as_tensor(v[0]), v[1]).device.type == 'cpu'
    assert nt.cross(v[0], v[1], device='cpu').device.type == 'cpu'


@pytest.mark.parametrize('dtype', [torch.float32, torch.int64])
def test_place_reads_a_list_of_arrays_or_tensors_as_one_array(dtype):
    """A list of per-batch arrays, or of CPU tensors, is one host array
    (numpy's reading, as the rasterizer's inputs always had)."""
    rows = [np.arange(3.) + 3 * i for i in range(4)]
    want = torch.as_tensor(np.stack(rows), dtype=dtype)
    cpu = torch.device('cpu')
    for value in (rows, [torch.as_tensor(r) for r in rows]):
        got = place(value, cpu, dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def test_as_tensors_keeps_torch_dtypes():
    """With no dtype asked, a list of floats is torch's float32 and a tensor
    keeps its own dtype."""
    a, b = as_tensors([[1., 2.], torch.zeros(2, dtype=torch.float64)])
    assert (a.dtype, b.dtype) == (torch.float32, torch.float64)
    assert a.device == b.device == torch.device('cpu')
