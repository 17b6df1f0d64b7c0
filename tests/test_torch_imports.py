"""The port imports without JAX and without Pillow.

In a fresh interpreter where ``import jax`` and ``import PIL`` fail (their
``sys.modules`` entries are None), ``neural_renderer_torch`` imports, loads
the teapot OBJ and renders it on the CPU.
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
assert not any(m.startswith('jax') and sys.modules[m] is not None
               for m in sys.modules)
print('IMPORT-OK')
'''


def test_imports_without_jax_and_pil():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert 'IMPORT-OK' in out.stdout, (out.stdout, out.stderr)
