"""The port's PNG and GIF code (``neural_renderer_torch/io/image.py``) with
Pillow as the reference.

Every PNG of the repository and random 8-bit grey, grey + alpha, RGB and
RGBA arrays saved by Pillow read bit-equal to Pillow; rows written with
each of the five PNG filter types decode; Pillow reads what ``imsave``
writes bit-equal; Pillow reads ``make_gif``'s GIF with its frame count,
size, delay and loop, and pixels equal to the palette-quantised frames;
other PNG kinds and broken files raise a ValueError naming what is wrong.
In a fresh interpreter where importing Pillow and imageio fails, the PNG
and GIF path runs and a JPEG raises an ImportError naming Pillow.
"""

import glob
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from neural_renderer_torch.io import image as nt_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_PNGS = sorted(
    os.path.relpath(p, ROOT) for d in ('examples/data', 'tests/data')
    for p in glob.glob(os.path.join(ROOT, d, '*.png')))
MODES = {'L': (), 'LA': (2,), 'RGB': (3,), 'RGBA': (4,)}


def _pillow(path):
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize('path', REPO_PNGS)
def test_repo_pngs_read_as_pillow(path):
    got = nt_image.imread(os.path.join(ROOT, path))
    want = _pillow(os.path.join(ROOT, path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_repo_pngs_are_all_here():
    assert {'examples/data/example2_ref.png', 'examples/data/example3_ref.png',
            'examples/data/example4_ref.png', 'tests/data/teapot_blender.png',
            'tests/data/test_depth.png'} <= set(REPO_PNGS)


def _random(mode, h=19, w=27, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w) + MODES[mode]).astype(np.uint8)


def _smooth(mode, h=40, w=52):
    """Gradients and stripes, which make Pillow pick Sub, Up and Paeth."""
    y, x = np.mgrid[:h, :w]
    planes = [(3 * x + y) % 256, (5 * y) % 256, (x * y) % 256, 255 - x]
    c = MODES[mode][0] if MODES[mode] else 1
    return np.stack(planes[:c], -1).reshape((h, w) + MODES[mode]).astype(
        np.uint8)


@pytest.mark.parametrize('mode', list(MODES))
def test_pillow_saved_arrays_read_back(tmp_path, mode):
    for k, array in enumerate((_random(mode), _smooth(mode))):
        path = str(tmp_path / f'{k}.png')
        Image.fromarray(array, mode).save(path)
        np.testing.assert_array_equal(nt_image.imread(path), array)


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _png(width, height, colour, raw, depth=8, interlace=0):
    return (b'\x89PNG\r\n\x1a\n'
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth,
                                          colour, 0, 0, interlace))
            + _chunk(b'IDAT', zlib.compress(raw)) + _chunk(b'IEND', b''))


def _filter_row(kind, cur, prior, bpp):
    """The PNG filter of one row (the specification's definitions)."""
    cur, prior = cur.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((cur - pred) % 256).astype(np.uint8)


@pytest.mark.parametrize('mode', ['LA', 'RGB'])
def test_every_filter_type_decodes(tmp_path, mode):
    """Rows filtered with types 0-4 in turn (Pillow never writes Average)
    decode to the array, as Pillow decodes them."""
    array = _random(mode, h=15, w=21, seed=4)
    h, w, bpp = array.shape
    rows, prior = [], np.zeros(w * bpp, np.uint8)
    for y in range(h):
        cur = array[y].reshape(-1)
        rows.append(bytes([y % 5]) + _filter_row(y % 5, cur, prior,
                                                 bpp).tobytes())
        prior = cur
    path = tmp_path / 'f.png'
    path.write_bytes(_png(w, h, {2: 4, 3: 2}[bpp], b''.join(rows)))
    np.testing.assert_array_equal(_pillow(str(path)), array)
    np.testing.assert_array_equal(nt_image.imread(str(path)), array)


@pytest.mark.parametrize('mode', list(MODES))
def test_pillow_reads_imsave(tmp_path, mode):
    array = _random(mode, seed=1)
    nt_image.imsave(str(tmp_path / 'a.png'), array)
    np.testing.assert_array_equal(_pillow(str(tmp_path / 'a.png')), array)
    # floats are clipped to [0, 255], as before
    nt_image.imsave(str(tmp_path / 'b.png'), array.astype(np.float32) * 2)
    np.testing.assert_array_equal(_pillow(str(tmp_path / 'b.png')),
                                  np.clip(array.astype(np.int64) * 2, 0, 255))


def test_make_gif_read_by_pillow(tmp_path):
    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 256, (24, 36, 3)).astype(np.uint8),
              rng.randint(0, 256, (24, 36)).astype(np.uint8),
              np.repeat(rng.randint(0, 256, (24, 36, 1)), 3, 2).astype(
                  np.uint8),
              rng.randint(0, 256, (24, 36, 4)).astype(np.uint8)]
    names = []
    for k, frame in enumerate(frames):
        names.append(str(tmp_path / f'{k}.png'))
        nt_image.imsave(names[-1], frame)
    names.append(str(tmp_path / 'f.png'))
    nt_image.imsave01(names[-1], rng.uniform(0, 1, (24, 36, 3)))
    frames.append(nt_image.imread(names[-1]))
    out = str(tmp_path / 'x.gif')
    nt_image.make_gif(names, out, fps=10)
    with Image.open(out) as gif:
        assert gif.n_frames == len(frames) and gif.size == (36, 24)
        assert gif.info['loop'] == 0 and gif.info['duration'] == 100
        for k, frame in enumerate(frames):
            gif.seek(k)
            got = np.asarray(gif.convert('RGB'))
            index = nt_image.gif_quantise(frame)
            np.testing.assert_array_equal(got, nt_image.GIF_PALETTE[index])
            # the quantisation's own error: half a cube step (51 / 2) for a
            # colour, half the gap between palette greys for a grey
            rgb = frame if frame.ndim == 3 else frame[..., None]
            err = np.abs(got.astype(np.int64) - rgb[..., :3])
            grey = ((rgb[..., 0] == rgb[..., 1 % rgb.shape[-1]])
                    & (rgb[..., 0] == rgb[..., 2 % rgb.shape[-1]]))
            assert err.max() <= 26
            assert not grey.any() or err[grey].max() <= 3


def test_make_gif_more_frames_than_a_run(tmp_path):
    """A frame of more pixels than one run of literal codes, and a GIF of
    many frames, decode exactly."""
    rng = np.random.RandomState(6)
    frames = [rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
              for _ in range(12)]
    names = []
    for k, frame in enumerate(frames):
        names.append(str(tmp_path / f'{k}.png'))
        nt_image.imsave(names[-1], frame)
    nt_image.make_gif(names, str(tmp_path / 'y.gif'))
    with Image.open(str(tmp_path / 'y.gif')) as gif:
        assert gif.n_frames == 12
        for k, frame in enumerate(frames):
            gif.seek(k)
            np.testing.assert_array_equal(
                np.asarray(gif.convert('RGB')),
                nt_image.GIF_PALETTE[nt_image.gif_quantise(frame)])


def test_other_png_kinds_raise(tmp_path):
    rng = np.random.RandomState(7)
    Image.fromarray(rng.randint(0, 256, (8, 8)).astype(np.uint8)).convert(
        'P').save(str(tmp_path / 'p.png'))
    with pytest.raises(ValueError, match='palette'):
        nt_image.imread(str(tmp_path / 'p.png'))
    Image.fromarray(rng.randint(0, 65536, (8, 8)).astype(np.uint16)).save(
        str(tmp_path / 'i16.png'))
    with pytest.raises(ValueError, match='16-bit'):
        nt_image.imread(str(tmp_path / 'i16.png'))
    (tmp_path / 'adam7.png').write_bytes(_png(4, 4, 2, bytes(4 * 13),
                                              interlace=1))
    with pytest.raises(ValueError, match='interlaced'):
        nt_image.imread(str(tmp_path / 'adam7.png'))
    good = bytearray(_png(4, 4, 0, bytes(4 * 5)))
    good[-20] ^= 0xFF               # a byte of the IDAT chunk
    (tmp_path / 'crc.png').write_bytes(bytes(good))
    with pytest.raises(ValueError, match='CRC'):
        nt_image.imread(str(tmp_path / 'crc.png'))
    (tmp_path / 'short.png').write_bytes(_png(4, 4, 0, bytes(4 * 5))[:40])
    with pytest.raises(ValueError, match='truncated'):
        nt_image.imread(str(tmp_path / 'short.png'))
    with pytest.raises(ValueError, match='shape'):
        nt_image.imsave(str(tmp_path / 'x.png'), np.zeros((2, 2, 5)))


SCRIPT = r'''
import glob, os, sys, tempfile
sys.modules['PIL'] = None
sys.modules['imageio'] = None
import numpy as np
from neural_renderer_torch.io import image
pngs = glob.glob('examples/data/*.png') + glob.glob('tests/data/*.png')
for p in sorted(pngs):
    assert image.imread(p).dtype == np.uint8, p
with tempfile.TemporaryDirectory() as d:
    names = []
    for k in range(3):
        names.append(f'{d}/{k}.png')
        image.imsave01(names[-1],
                       np.random.RandomState(k).uniform(0, 1, (9, 7, 3)))
    image.imsave(f'{d}/g.png', np.zeros((9, 7), np.uint8))
    image.make_gif(names, f'{d}/a.gif')
    assert open(f'{d}/a.gif', 'rb').read(6) == b'GIF89a'
    try:
        image.imsave(f'{d}/x.jpg', np.zeros((4, 4, 3), np.uint8))
    except ImportError as e:
        assert 'Pillow' in str(e), e
    else:
        raise AssertionError('a JPEG was written without Pillow')
jpg = sorted(glob.glob('tests/data/*/images/*.jpg'))[0]
try:
    image.imread(jpg)
except ImportError as e:
    assert 'Pillow' in str(e), e
else:
    raise AssertionError('a JPEG was read without Pillow')
assert not any(m.split('.')[0] in ('PIL', 'imageio')
               and sys.modules[m] is not None for m in sys.modules)
print('NO-PILLOW-OK')
'''


def test_png_and_gif_need_no_pillow_or_imageio():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert 'NO-PILLOW-OK' in out.stdout, (out.stdout, out.stderr)
