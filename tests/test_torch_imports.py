"""The port imports without JAX and without Pillow.

In a fresh interpreter where ``import jax`` and ``import PIL`` fail (their
``sys.modules`` entries are None), ``neural_renderer_torch`` and all its
modules (``parallel``, the native OBJ parser, spatial order, the segmented
sum) import, load the teapot OBJ, save it untextured, order its faces and
render it on the CPU.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import sys
sys.modules['jax'] = None
sys.modules['PIL'] = None
import torch
torch.set_num_threads(1)
import neural_renderer_torch as nt
v, f = nt.load_obj('tests/data/teapot.obj')
assert v.shape == (1292, 3) and f.shape == (2464, 3), (v.shape, f.shape)
r = nt.Renderer()
r.image_size = 32
sil = r.render_silhouettes(
    *nt.arrays_from_numpy(v[None], f[None], device='cpu')[:2])
assert sil.shape == (1, 32, 32) and float(sil.max()) == 1.0
import tempfile
import neural_renderer_torch.parallel
import neural_renderer_torch.io.native
import neural_renderer_torch.ops.segments
with tempfile.TemporaryDirectory() as d:
    nt.save_obj(d + '/t.obj', v, f)
    v2, f2 = nt.load_obj(d + '/t.obj', use_native=False)
    assert (f2 == f).all()
assert nt.face_spatial_order(v, f).shape == (2464,)
nt.use_unsafe_rasterizer(False)
init, update = nt.adam()
assert not any(m.startswith('jax') and sys.modules[m] is not None
               for m in sys.modules)
assert not any(m.startswith('neural_renderer_tpu') for m in sys.modules)
print('IMPORT-OK')
'''


def test_imports_without_jax_and_pil():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert 'IMPORT-OK' in out.stdout, (out.stdout, out.stderr)
