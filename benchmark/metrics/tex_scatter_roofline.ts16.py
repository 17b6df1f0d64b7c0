"""The texture gradient's share of its roofline in the ts-16 training step,
in %: the least time of what the gradient of cubes above ts 4 needs on the
reference's face-index map (``tex_scatter_work``) over the device time per
step of the kernels that compute it.

The work is counted from the reference's face-index map, whatever
implements it.  Each covered raster pixel adds its rgb gradient, times the
trilinear weight of each of the 8 corners around its perspective-corrected
texture coordinate, to 8 cells of its winning face's ``ts^3`` cube.
Bytes: per covered pixel the rgb gradient (12), the winner's vertex depths
and barycentric weights (24) and the pixel's depth (4) read once, the
face-index map read once (4 bytes a raster pixel), and the whole gradient
cube, ``bs * nf' * ts^3 * 3`` floats, written once.  Operations per covered
pixel: for each of the 8 corners the weight's 2 products, the 3 products of
the weight and the gradient and the 3 adds (64).  How an implementation
orders the adds (rows sorted by cell and summed in order, or a face's cube
summed in shared memory) is its own choice and not counted; bytes bind by
far.

Time: the kernels whose names hold ``RadixSort`` (the sort of the corner
rows by cell), ``searchsorted`` (the segment starts), ``segment_sum_kernel``
(the sums in order) or ``tex_scatter``.  A later kernel that computes this
gradient is to be named ``tex_scatter...``, so that this share goes on
reading the same work.  The vertex gradient's ``segment_sum_kernel``
launch, about 0.006 ms a step, falls inside this time too; the plain torch
that builds the corner rows does not."""

from benchmark import roofline, trace

NAME = 'tex_scatter_roofline.ts16'
KERNELS = ('RadixSort', 'searchsorted', 'segment_sum_kernel', 'tex_scatter')
# bytes read per covered raster pixel: rgb gradient, z and weights, depth
PIXEL_BYTES = 12 + 24 + 4
# operations per covered raster pixel: 8 corners x (2 + 3 + 3)
PIXEL_OPS = 8 * (2 + 3 + 3)
# batch elements per block of the reference's face-index map
BLOCK = 8


def tex_scatter_work(fim, nf, ts, weights=None):
    """{'bytes', 'ops', 'covered'} of the texture gradient of one raster:
    ``fim`` ``[bs, is, is]`` the reference's face-index map of ``nf``
    faces (after fill_back) with ``ts``-texel cubes, batch element ``b``
    counted ``weights[b]`` times."""
    bs = roofline.count(weights, fim.shape[0])
    covered = roofline._weighted((fim >= 0).sum((1, 2)), weights)
    nbytes = (PIXEL_BYTES * covered
              + 4 * bs * fim.shape[1] * fim.shape[2]
              + roofline.F32 * bs * nf * ts ** 3 * 3)
    return dict(bytes=nbytes, ops=PIXEL_OPS * covered, covered=covered)


def work(stretch):
    ts = stretch.cfg['texture_size']

    def one(key):
        faces, weights = stretch.faces_ndc(key)
        return tex_scatter_work(stretch.face_index(key, BLOCK),
                                faces.shape[1], ts, weights)
    return stretch.per_call(one)


def read(rec):
    return trace.roofline_pct(rec, NAME, KERNELS)
