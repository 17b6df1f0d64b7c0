"""``misc/torch_multiview.py`` against ``misc/multiview.py``.

The port's script at ``--views 4 --image_size 32 --iters 1 --device cpu``
(a 64^2 raster with AA): its rgb, alpha and depth against the JAX
package's ``Renderer.render_rgbad`` run eagerly (ROADMAP Queue 3) with the
same ``[4, 3]`` eyes, made as the JAX script makes them (bit-equal to the
port's), within the tolerances stated at the check; the script's one-rank
group path bit-equal to the port's ``render_rgbad`` on the same batch; and
``tune`` called on every ``max(1, views // 8)``-th eye.
"""

import contextlib
import importlib.util
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ['--views', '4', '--image_size', '32', '--iters', '1', '--device',
        'cpu']
# measured: rgb 1.2e-7, alpha 0, depth 1.9e-5 (the pooled far plane, 100,
# at the silhouette); the camera-rotation pin of ROADMAP Queue 3 would
# allow 1.66e-4 in rgb.  Depth is held to 1e-6 of the far plane
ATOL = {'rgb': 1e-6, 'alpha': 1e-6, 'depth': 1e-4}


@pytest.fixture(scope='module')
def script():
    path = os.path.join(ROOT, 'misc', 'torch_multiview.py')
    spec = importlib.util.spec_from_file_location('test_torch_multiview_',
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def ran(script):
    """(outputs, timings, printed lines, the eyes tune saw) of one run."""
    seen = []
    tune = nt.tune

    def recording(renderer, vertices, faces, eyes=None, **kwargs):
        seen.append(torch.stack(list(eyes)))
        return tune(renderer, vertices, faces, eyes=eyes, **kwargs)

    buf = io.StringIO()
    nt.tune = recording
    try:
        with contextlib.redirect_stdout(buf):
            out, timing = script.run(ARGV)
    finally:
        nt.tune = tune
    return out, timing, buf.getvalue().strip().splitlines(), seen


def _jax_outputs(views, image_size):
    """misc/multiview.py's scene and eyes through the JAX package's eager
    ``render_rgbad``."""
    v, f = nr.load_obj(os.path.join(ROOT, 'tests', 'data', 'teapot.obj'))
    eyes = jnp.asarray(np.stack([
        np.asarray(nr.get_points_from_angles(
            np.float32(2.732), np.float32(30.0), np.float32(a)))
        for a in np.linspace(0, 360, views, endpoint=False)]))
    r = nr.Renderer()
    r.image_size = image_size
    r.eye = eyes
    out = r.render_rgbad(
        jnp.broadcast_to(jnp.asarray(v), (views,) + v.shape),
        jnp.broadcast_to(jnp.asarray(f), (views,) + f.shape),
        jnp.ones((views, f.shape[0], 2, 2, 2, 3), jnp.float32))
    return {k: np.asarray(x) for k, x in out.items()}, np.asarray(eyes)


def test_outputs_match_jax(script, ran):
    out, _, _, _ = ran
    want, eyes_j = _jax_outputs(4, 32)
    _, _, _, _, eyes = script.build(script.parse_args(ARGV))
    assert np.array_equal(eyes.numpy(), eyes_j)
    for k in ('rgb', 'alpha', 'depth'):
        assert out[k].shape == want[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=0,
                                   atol=ATOL[k], err_msg=k)
    assert float(out['alpha'].amax()) == 1.0


def test_one_rank_group_equals_render_rgbad(script, ran):
    out, timing, lines, _ = ran
    renderer, v, f, tx, eyes = script.build(script.parse_args(ARGV))
    assert renderer.eye is eyes
    with torch.no_grad():
        want = renderer.render_rgbad(v, f, tx)
    for k in ('rgb', 'alpha', 'depth'):
        assert torch.equal(out[k], want[k]), k
    assert timing['ranks'] == 1 and timing['images_per_s'] > 0
    assert lines[0].startswith('4 views @ 32^2 rgb+alpha+depth over 1 '
                               'device(s): ')
    assert [ln.split(':')[0].strip() for ln in lines[1:]] == [
        'rgb', 'alpha', 'depth']
    # the script's group is gone after the run
    assert not torch.distributed.is_initialized()


def test_tune_sees_every_eighth_eye(script, ran):
    _, _, _, seen = ran
    _, _, _, _, eyes = script.build(script.parse_args(ARGV))
    assert len(seen) == 1
    assert torch.equal(seen[0], eyes)   # 4 views: every eye
    assert script.tuned_eyes(list(range(64))) == list(range(0, 64, 8))
    assert script.tuned_eyes(list(range(20))) == list(range(0, 20, 2))
