"""The port imports without JAX and without Pillow.

In a fresh interpreter where ``import jax`` and ``import PIL`` fail (their
``sys.modules`` entries are None), ``neural_renderer_torch`` and all its
modules (``parallel``, the native OBJ parser, spatial order, the segmented
sum) import, load the teapot OBJ, save it untextured, order its faces and
render it on the CPU.  Likewise the port's examples
(``examples/torch_example{1,2,3,4}.py``), gradient-quality study
(``misc/torch_grad_quality.py``) and dataset renderer
(``misc/torch_render.py``, which renders an OBJ without materials there)
import where jax, Pillow, imageio and tqdm cannot, and import neither JAX
nor ``neural_renderer_tpu``; so do the reference timing protocol
(``misc/torch_measure_time.py``) and BASELINE config 5
(``misc/torch_multiview.py``), each run once at a tiny size.
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


# the port's examples, study and dataset renderer, imported by path where
# jax, Pillow, imageio and tqdm cannot be imported; example 1 renders one
# small frame, the dataset renderer one view of the tetrahedron
SCRIPTS = r'''
import importlib.util, sys
for m in ('jax', 'PIL', 'imageio', 'tqdm'):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
mods = {}
for path in ['examples/torch_example1.py', 'examples/torch_example2.py',
             'examples/torch_example3.py', 'examples/torch_example4.py',
             'misc/torch_grad_quality.py', 'misc/torch_render.py']:
    spec = importlib.util.spec_from_file_location(path.replace('/', '_'), path)
    mods[path] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[path])
    assert callable(mods[path].run), path
ex1 = mods['examples/torch_example1.py']
v, f, t, r = ex1.build('examples/data/teapot.obj', 'cpu')
r.image_size = 32
assert ex1.render_sweep(r, v, f, t, [30]).shape == (1, 3, 32, 32)
import shutil, tempfile
with tempfile.TemporaryDirectory() as d:
    shutil.copy('tests/data/tetrahedron.obj', d)
    paths = mods['misc/torch_render.py'].run(
        ['-i', d, '-o', d + '/out', '-n', '1', '-is', '16', '--device', 'cpu'])
    assert [p.rsplit('/', 1)[1] for p in paths] == ['tetrahedron_00.png']
assert not any(m.startswith('jax') and sys.modules[m] is not None
               for m in sys.modules)
assert not any(m.startswith('neural_renderer_tpu') for m in sys.modules)
print('SCRIPTS-OK')
'''


def test_examples_and_study_import_without_jax():
    out = subprocess.run([sys.executable, '-c', SCRIPTS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert 'SCRIPTS-OK' in out.stdout, (out.stdout, out.stderr)


# the port's scripts of the reference timing protocol and of BASELINE
# config 5, imported by path where jax and Pillow cannot be imported; each
# runs once at a tiny size on the CPU
TIMING = r'''
import contextlib, importlib.util, io, sys
for m in ('jax', 'PIL', 'tqdm'):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
mods = {}
for path in ['misc/torch_measure_time.py', 'misc/torch_multiview.py']:
    spec = importlib.util.spec_from_file_location(path.replace('/', '_'), path)
    mods[path] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[path])
mt = mods['misc/torch_measure_time.py']
calls = mt.build(mt.parse_args(['-is', '16', '--device', 'cpu']))
eye = mt.eye_at(30, 'cpu')
assert calls[0](eye).shape == (1, 16, 16)
assert calls[3](eye)[1].shape == (1, 2464, 2, 2, 2, 3)
with contextlib.redirect_stdout(io.StringIO()):
    out, timing = mods['misc/torch_multiview.py'].run(
        ['--views', '2', '--image_size', '16', '--iters', '1', '--device',
         'cpu'])
assert out['rgb'].shape == (2, 3, 16, 16) and timing['ranks'] == 1
assert not any(m.startswith('jax') and sys.modules[m] is not None
               for m in sys.modules)
assert not any(m.startswith('neural_renderer_tpu') for m in sys.modules)
print('TIMING-OK')
'''


def test_timing_scripts_import_without_jax():
    out = subprocess.run([sys.executable, '-c', TIMING], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert 'TIMING-OK' in out.stdout, (out.stdout, out.stderr)
