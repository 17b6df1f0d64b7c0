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
