"""The port's OBJ save, texture atlas, image helpers and native OBJ parser
against the JAX package's.

``save_obj`` round trips plain and textured meshes (as tests/test_save_obj.py
does for the JAX package); ``create_texture_image`` equals the JAX
package's within 1e-6 on random cubes from a numpy seed; ``imsave01``
writes the same pixels as the JAX package's; ``make_gif`` keeps every
frame; the port's native parser (its own copy of the C++ source, built into
``neural_renderer_torch/_build/``) equals the JAX package's native parser
and both pure-Python parsers on the teapot, on quads and on negative
indices.
"""

import os

import numpy as np
import pytest
import torch

import neural_renderer_torch as nt
import neural_renderer_tpu as nr
from neural_renderer_torch.io import image as nt_image
from neural_renderer_torch.io import native as nt_native
from neural_renderer_torch.io import obj as nt_obj
from neural_renderer_tpu.io import image as nr_image
from neural_renderer_tpu.io import native as nr_native
from neural_renderer_tpu.io import obj as nr_obj

DATA = os.path.join(os.path.dirname(__file__), 'data')
TEAPOT = os.path.join(DATA, 'teapot.obj')


def test_save_obj_roundtrip(tmp_path):
    vertices, faces = nt.load_obj(TEAPOT)
    out = str(tmp_path / 'teapot2.obj')
    nt.save_obj(out, torch.tensor(vertices), torch.tensor(faces))
    vertices2, faces2 = nt.load_obj(out)
    np.testing.assert_allclose(vertices, vertices2, atol=1e-6)
    np.testing.assert_array_equal(faces, faces2)
    # the JAX package writes the same file
    nr.save_obj(str(tmp_path / 'teapot3.obj'), vertices, faces)
    assert (open(out).read().splitlines()[1:]
            == open(tmp_path / 'teapot3.obj').read().splitlines()[1:])


def test_save_obj_textured_roundtrip(tmp_path):
    """Flat-coloured cubes survive the atlas bake and the reload within
    quantization (0.05), and the atlas PNG equals the JAX package's."""
    vertices = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], 'float32')
    faces = np.array([[0, 1, 2], [1, 2, 3]], 'int32')
    colors = np.array([[0.8, 0.2, 0.1], [0.1, 0.9, 0.3]], 'float32')
    textures = np.broadcast_to(
        colors[:, None, None, None, :], (2, 4, 4, 4, 3)).copy()

    out = str(tmp_path / 'mesh.obj')
    nt.save_obj(out, vertices, faces, torch.tensor(textures))
    assert os.path.exists(str(tmp_path / 'mesh.mtl'))
    assert os.path.exists(str(tmp_path / 'mesh.png'))
    v2, f2, t2 = nt.load_obj(out, normalization=False, texture_size=4,
                             load_texture=True)
    np.testing.assert_allclose(vertices, v2)
    np.testing.assert_array_equal(faces, f2)
    for i in range(2):
        np.testing.assert_allclose(
            t2[i].reshape(-1, 3).mean(0), colors[i], atol=0.05)
    (tmp_path / 'jax').mkdir()
    nr.save_obj(str(tmp_path / 'jax' / 'mesh.obj'), vertices, faces,
                textures)
    np.testing.assert_array_equal(
        nt_image.imread(str(tmp_path / 'mesh.png')),
        nr_image.imread(str(tmp_path / 'jax' / 'mesh.png')))


@pytest.mark.parametrize('nf,tsi,tso', [(5, 4, 16), (7, 2, 8), (1, 3, 4)])
def test_create_texture_image_matches_jax(nf, tsi, tso):
    textures = np.random.RandomState(nf).uniform(
        size=(nf, tsi, tsi, tsi, 3)).astype('float32')
    image, uv = nt.create_texture_image(torch.tensor(textures), tso)
    want_image, want_uv = nr.create_texture_image(textures, tso)
    assert image.shape == np.asarray(want_image).shape
    np.testing.assert_allclose(image, np.asarray(want_image), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(uv, np.asarray(want_uv), atol=1e-6, rtol=0)
    assert (uv >= 0).all() and (uv <= 1).all()


def test_imsave01_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    img = rng.uniform(-0.2, 1.2, (17, 23, 3)).astype(np.float32)
    nt_image.imsave01(str(tmp_path / 'a.png'), img)
    nr_image.imsave01(str(tmp_path / 'b.png'), img)
    a = nt_image.imread(str(tmp_path / 'a.png'))
    np.testing.assert_array_equal(a, nr_image.imread(str(tmp_path / 'b.png')))
    assert a.dtype == np.uint8 and a.shape == (17, 23, 3)


def test_make_gif_frame_count(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(4)
    names = []
    for i in range(5):
        names.append(str(tmp_path / f'f{i}.png'))
        nt_image.imsave01(names[-1], rng.uniform(0, 1, (16, 16, 3)))
    out = str(tmp_path / 'x.gif')
    nt_image.make_gif(names, out)
    assert Image.open(out).n_frames == 5


def _parsers(path, **kw):
    """(vertices, faces) of the port's and the JAX package's native and
    pure-Python parsers."""
    return [nt_obj.load_obj(path, use_native=True, **kw),
            nt_obj.load_obj(path, use_native=False, **kw),
            nr_obj.load_obj(path, use_native=True, **kw),
            nr_obj.load_obj(path, use_native=False, **kw)]


def _assert_all_equal(results):
    for v, f in results[1:]:
        np.testing.assert_array_equal(results[0][0], v)
        np.testing.assert_array_equal(results[0][1], f)


def test_native_parser_builds_into_build_dir():
    assert nt_native.available()
    lib = nt_native._build.build_host('fast_obj')
    assert lib.parent.name == '_build' and lib.parent.parent.name == (
        'neural_renderer_torch')


def test_native_teapot_parity():
    results = _parsers(TEAPOT)
    assert results[0][0].shape == (1292, 3)
    _assert_all_equal(results)


def test_native_quads_and_negative_indices(tmp_path):
    p = tmp_path / 'm.obj'
    p.write_text(
        'v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n'
        'f 1 2 3 4\n'
        'f -4//1 -3/2/ -2\n')
    results = _parsers(str(p), normalization=False)
    _assert_all_equal(results)
    np.testing.assert_array_equal(results[0][1],
                                  [[0, 1, 2], [0, 2, 3], [0, 1, 2]])


def test_native_negative_indices_interleaved(tmp_path):
    p = tmp_path / 'm.obj'
    p.write_text(
        'v 0 0 0\nv 1 0 0\nv 1 1 0\n'
        'f -3 -2 -1\n'
        'v 0 1 0\nv 0 0 1\nv 1 0 1\n'
        'f -3 -2 -1\n')
    results = _parsers(str(p), normalization=False)
    _assert_all_equal(results)
    np.testing.assert_array_equal(results[0][1], [[0, 1, 2], [3, 4, 5]])
