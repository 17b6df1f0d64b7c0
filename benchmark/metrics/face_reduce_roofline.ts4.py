"""The per-face reduction's share of its roofline in the ts-4 training
step, in %: the least time of what the reduction needs on the reference's
face-index map (``face_reduce_work``) over the device time per step of the
reduction's kernels (the tile pass and the face pass).

The work is counted from the reference's face-index map, whatever
implements it.  The reduction sums, per face, a stack of per-pixel
channels over the pixels the face won: the 12 K5 channels and the ``ts^2 +
ts + 3`` K6 factors (35 at ts 4), and leaves ``12 + 3 ts^3`` columns a face
(204 at ts 4), the factors expanded to texture cells.  Bytes: each covered
raster pixel's channels read once (4 bytes each), the face-index map read
once (4 bytes a raster pixel), the ``[bs * nf', 12 + 3 ts^3]`` sums written
once.  Operations per covered pixel: an add for each of the 12 K5 channels,
and for each of the ``3 ts^3`` cell columns the two products of its factors
and an add.  How an implementation orders the sums (partial rows per tile
and face, a sort of a tile's pixels) is its own choice and not counted;
bytes bind by far."""

from benchmark import roofline, trace

NAME = 'face_reduce_roofline.ts4'
KERNELS = ('face_reduce_tile_kernel', 'face_reduce_face_kernel')
K5 = 12
# batch elements per block of the reference's face-index map
BLOCK = 8


def face_reduce_work(fim, nf, ts, weights=None):
    """{'bytes', 'ops', 'covered'} of the reduction of one raster: ``fim``
    ``[bs, is, is]`` the reference's face-index map of ``nf`` faces (after
    fill_back) with ``ts``-texel cubes, batch element ``b`` counted
    ``weights[b]`` times."""
    bs = roofline.count(weights, fim.shape[0])
    covered = roofline._weighted((fim >= 0).sum((1, 2)), weights)
    c_in = K5 + ts * ts + ts + 3
    c_out = K5 + 3 * ts ** 3
    nbytes = (roofline.F32 * covered * c_in
              + 4 * bs * fim.shape[1] * fim.shape[2]
              + roofline.F32 * bs * nf * c_out)
    return dict(bytes=nbytes, ops=covered * (K5 + 3 * 3 * ts ** 3),
                covered=covered)


def work(stretch):
    ts = stretch.cfg['texture_size']

    def one(key):
        faces, weights = stretch.faces_ndc(key)
        return face_reduce_work(stretch.face_index(key, BLOCK),
                                faces.shape[1], ts, weights)
    return stretch.per_call(one)


def read(rec):
    return trace.roofline_pct(rec, NAME, KERNELS)
