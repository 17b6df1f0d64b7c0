"""Image I/O: PNG and GIF on the standard library, other formats through
Pillow.

Stand-ins for the reference's scipy.misc.imread / imsave / toimage usage.
PNG (read and written) and GIF (written by ``make_gif``) are this module's
own code on ``zlib`` and ``struct``, so the examples run where neither
Pillow nor imageio is installed.  Any other format (the JPEG textures that
``load_textures`` reads) goes to Pillow: ``imread`` tells the format by the
file's signature, ``imsave`` by its suffix, and where Pillow is missing the
call raises an ``ImportError`` that says so.  This is dispatch by format,
not a fallback: PNG and GIF never go through Pillow, even where it is
installed.

``imsave01`` maps float [0, 1] to uint8 like ``scipy.misc.toimage(x,
cmin=0, cmax=1)``.
"""

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# 8-bit colour types this module reads and writes -> channels, and back
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_PNG_COLOUR = {v: k for k, v in _PNG_CHANNELS.items()}
_PNG_COLOUR_NAMES = {0: 'grey', 2: 'RGB', 3: 'palette', 4: 'grey + alpha',
                     6: 'RGBA'}


def _pillow(what):
    """PIL.Image, or an ImportError naming what needed it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f'{what} needs Pillow, which is not installed '
                          '(PNG and GIF need no Pillow)') from e
    return Image


def imread(path):
    """Image file -> uint8 array, like scipy.misc.imread: [h, w] grey,
    [h, w, 2] grey + alpha, [h, w, 3] RGB, [h, w, 4] RGBA.

    PNG (8-bit grey, grey + alpha, RGB or RGBA, not interlaced) is decoded
    here; any other PNG raises a ValueError naming its kind, any other
    format goes to Pillow."""
    with open(path, 'rb') as fh:
        data = fh.read()
    if data.startswith(_PNG_SIGNATURE):
        return _decode_png(data, path)
    with _pillow(f'reading {path} (not a PNG)').open(path) as image:
        return np.asarray(image)


def _png_chunks(data, path):
    """(kind, body) of each chunk up to IEND, CRCs checked."""
    pos = len(_PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f'{path}: truncated PNG (no IEND chunk)')
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f'{path}: truncated PNG chunk {kind!r}')
        body = data[pos + 8:end]
        crc, = struct.unpack('>I', data[end:end + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f'{path}: PNG chunk {kind!r} fails its CRC')
        if kind == b'IEND':
            return
        yield kind, body
        pos = end + 4


def _decode_png(data, path):
    header, idat = None, []
    for kind, body in _png_chunks(data, path):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind != b'PLTE' and not kind[0] & 0x20:
            # an unknown critical chunk (ancillary ones are lower case)
            raise ValueError(f'{path}: PNG with the critical chunk {kind!r} '
                             'is not supported')
    if header is None:
        raise ValueError(f'{path}: PNG without an IHDR chunk')
    width, height, depth, colour, compression, filtering, interlace = header
    channels = _PNG_CHANNELS.get(colour)
    if channels is None or depth != 8:
        name = _PNG_COLOUR_NAMES.get(colour, f'colour type {colour}')
        raise ValueError(f'{path}: PNG of {depth}-bit {name} pixels is not '
                         'supported (8-bit grey, grey + alpha, RGB and RGBA '
                         'are)')
    if interlace:
        raise ValueError(f'{path}: Adam7-interlaced PNG is not supported')
    if compression or filtering:
        raise ValueError(f'{path}: PNG with compression method {compression} '
                         f'and filter method {filtering} is not supported')
    raw = zlib.decompress(b''.join(idat))
    stride = width * channels
    if len(raw) != height * (stride + 1):
        raise ValueError(f'{path}: PNG image data holds {len(raw)} bytes, '
                         f'{height * (stride + 1)} expected')
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        out[y] = _unfilter(rows[y, 0], rows[y, 1:], prior, channels, path)
        prior = out[y]
    return out.reshape((height, width) if channels == 1
                       else (height, width, channels))


def _unfilter(kind, line, prior, bpp, path):
    """One scanline's bytes from its filtered bytes (PNG filter types 0-4;
    ``prior`` is the row above, zeros for the first)."""
    if kind == 0:
        return line
    if kind == 1:       # Sub: a running sum per channel, mod 256
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:       # Up
        return line + prior
    if kind not in (3, 4):
        raise ValueError(f'{path}: PNG scanline with filter type {kind}')
    # Average and Paeth read the byte just decoded on the left
    cur, up = bytearray(line.tobytes()), prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _png_chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _encode_png(array):
    """uint8 [h, w] or [h, w, 2|3|4] -> PNG bytes (every row filter type 0,
    zlib level 6)."""
    height, width = array.shape[:2]
    channels = 1 if array.ndim == 2 else array.shape[2]
    colour = _PNG_COLOUR[channels]
    raw = np.zeros((height, width * channels + 1), np.uint8)
    raw[:, 1:] = array.reshape(height, -1)
    return (_PNG_SIGNATURE
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8,
                                              colour, 0, 0, 0))
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b'IEND', b''))


def imsave(path, array):
    """Save an array as an image (clipped to [0, 255] uint8): [h, w] grey,
    [h, w, 2] grey + alpha, [h, w, 3] RGB or [h, w, 4] RGBA.  A ``.png``
    path is written here; any other suffix goes to Pillow."""
    array = np.asarray(array)
    if array.dtype != np.uint8:
        array = np.clip(array, 0, 255).astype(np.uint8)
    if not (array.ndim == 2 or (array.ndim == 3 and 2 <= array.shape[2] <= 4)):
        raise ValueError(f'cannot save an image of shape {array.shape}')
    if not str(path).lower().endswith('.png'):
        _pillow(f'writing {path} (not a .png)').fromarray(array).save(path)
        return
    with open(path, 'wb') as fh:
        fh.write(_encode_png(np.ascontiguousarray(array)))


def imsave01(path, array):
    """Save a float array scaled from [0, 1] (clipped) to uint8."""
    array = np.asarray(array, np.float32)
    imsave(path, (np.clip(array, 0.0, 1.0) * 255.0).round().astype(np.uint8))


# The GIF's one fixed palette: a 6 x 6 x 6 colour cube (levels 0, 51, ...,
# 255; index 36 r + 6 g + b), then 40 more greys between the cube's six
_CUBE_LEVEL = (np.arange(256) * 5 + 127) // 255       # value -> nearest level
_EXTRA_GREYS = np.round(np.linspace(0, 255, 42)[1:-1]).astype(np.int64)
GIF_PALETTE = np.concatenate([
    51 * np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(6),
                              indexing='ij'), -1).reshape(-1, 3),
    np.repeat(_EXTRA_GREYS[:, None], 3, 1)]).astype(np.uint8)
_IS_GREY = ((GIF_PALETTE[:, 0] == GIF_PALETTE[:, 1])
            & (GIF_PALETTE[:, 1] == GIF_PALETTE[:, 2]))
# grey value -> index of the nearest palette grey
_GREY_INDEX = np.flatnonzero(_IS_GREY)[np.abs(
    np.arange(256)[:, None]
    - GIF_PALETTE[_IS_GREY, 0].astype(np.int64)[None]).argmin(1)]
# literal codes between clear codes: after a clear, a decoder adds a table
# entry from the second code on, starting at 258, and widens its 9-bit
# codes once it has added entry 511 (after the 255th code); 254 keeps one
# code to spare
_GIF_RUN = 254


def gif_quantise(frame):
    """uint8 [h, w] or [h, w, 2|3|4] -> [h, w] indices into ``GIF_PALETTE``:
    a grey pixel to the nearest palette grey, any other to the nearest cube
    colour (alpha is dropped)."""
    frame = np.asarray(frame)
    if frame.ndim == 2 or frame.shape[2] == 2:
        grey = frame if frame.ndim == 2 else frame[..., 0]
        return _GREY_INDEX[grey].astype(np.uint8)
    r, g, b = (frame[..., k].astype(np.int64) for k in range(3))
    cube = 36 * _CUBE_LEVEL[r] + 6 * _CUBE_LEVEL[g] + _CUBE_LEVEL[b]
    return np.where((r == g) & (g == b), _GREY_INDEX[r], cube).astype(np.uint8)


def _lzw_literal(indices):
    """GIF image data (minimum code size 8, 9-bit codes) of 8-bit indices:
    each index its literal code, a clear code before every ``_GIF_RUN``,
    the end code last; packed least significant bit first into sub-blocks
    of at most 255 bytes."""
    n = indices.size
    runs = -(-n // _GIF_RUN)
    codes = np.full((runs, _GIF_RUN + 1), 256, np.uint16)
    flat = np.zeros(runs * _GIF_RUN, np.uint16)
    flat[:n] = indices.reshape(-1)
    codes[:, 1:] = flat.reshape(runs, _GIF_RUN)
    codes = np.append(codes.reshape(-1)[:n + runs], np.uint16(257))
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(
        np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder='little').tobytes()
    blocks = [data[i:i + 255] for i in range(0, len(data), 255)]
    return (b'\x08' + b''.join(bytes([len(c)]) + c for c in blocks)
            + b'\x00')


def make_gif(filenames, output_path, fps=12):
    """Assemble image frames (PNG) into a looping GIF (replaces the
    reference's ImageMagick ``convert`` subprocess,
    examples/example1.py:57-58): every frame quantised to the one fixed
    256-colour ``GIF_PALETTE`` (``gif_quantise``), ``round(100 / fps)``
    hundredths of a second each."""
    frames = [gif_quantise(imread(f)) for f in filenames]
    if not frames:
        raise ValueError('make_gif needs at least one frame')
    height, width = frames[0].shape
    delay = max(1, round(100 / fps))
    out = [b'GIF89a',
           # global colour table of 2^(7+1) entries, colour resolution 8 bits
           struct.pack('<HHBBB', width, height, 0xF7, 0, 0),
           GIF_PALETTE.tobytes(),
           # loop forever
           b'\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00']
    for name, index in zip(filenames, frames):
        if index.shape != (height, width):
            raise ValueError(f'{name}: frame of {index.shape[::-1]} pixels in '
                             f'a GIF of {width} x {height}')
        # graphic control: do not dispose, no transparency, the delay
        out.append(b'\x21\xf9\x04' + struct.pack('<BHB', 0x04, delay, 0)
                   + b'\x00')
        out.append(b'\x2c' + struct.pack('<HHHHB', 0, 0, width, height, 0))
        out.append(_lzw_literal(index))
    out.append(b'\x3b')
    with open(output_path, 'wb') as fh:
        fh.write(b''.join(out))
