"""The setup and binning's share of its roofline in the silhouette training
step, in %: the least time of what the forward's tile lists need over the
device time per step of the binning's kernels (count, CUB's scan, fill).

The work is counted from the reference's NDC faces, whatever implements
it: each face's 9 coordinates read (36 bytes), the forward's 18-float
record written (72 bytes), one 4-byte face id per (tile, face) pair and
one 4-byte start per tile.  A face's pairs are the tiles that hold a pixel
centre of its bounding box, clipped to the image, for each front face with
finite coordinates.  How an implementation finds them (a grid of tiles by
chunks of faces, a pad for rounding) is its own choice and not counted.
Operations: per face its front test (7) and the record's barycentric
matrix from pixel coordinates (56: 24 for the six coordinates, 8 for the
determinant, 15 for the entries, 9 divisions); bytes bind by far."""

import torch

from benchmark import roofline, trace
from benchmark.reference import raster

NAME = 'binning_roofline.sil'
KERNELS = ('bin_count_kernel', 'DeviceScan', 'bin_fill_kernel')
# the forward kernels read lists of 16-pixel tiles
TILE = 16
FACE_BYTES = 4 * 9
RECORD_BYTES = 4 * 18
ID_BYTES = 4
START_BYTES = 4
FACE_OPS = 7 + 56


def tile_pairs(faces_ndc, is_, tile=TILE, weights=None):
    """(tile, face) pairs of ``faces_ndc`` ``[bs, nf, 3, 3]`` at ``is_``
    in ``tile``-pixel tiles, batch element ``b`` counted ``weights[b]``
    times; an int."""
    def span(p):
        p = raster.to_pixel(p, is_)
        lo = torch.clamp(torch.ceil(p.amin(-1)), min=0.0)
        hi = torch.clamp(torch.floor(p.amax(-1)), max=is_ - 1.0)
        n = torch.floor(hi / tile) - torch.floor(lo / tile) + 1.0
        return (torch.where(hi >= lo, n, torch.zeros_like(n)),
                torch.isfinite(p).all(-1))

    nx, fx = span(faces_ndc[..., 0])
    ny, fy = span(faces_ndc[..., 1])
    keep = raster.is_front(faces_ndc) & fx & fy
    return roofline._weighted(
        torch.where(keep, nx * ny, torch.zeros_like(nx)).sum(-1), weights)


def binning_work(faces_ndc, is_, weights=None):
    """{'bytes', 'ops', 'pairs'} of the tile lists of one raster."""
    nf = faces_ndc.shape[1]
    bs = roofline.count(weights, faces_ndc.shape[0])
    nt = -(-is_ // TILE)
    pairs = tile_pairs(faces_ndc, is_, TILE, weights)
    nbytes = ((FACE_BYTES + RECORD_BYTES) * bs * nf + ID_BYTES * pairs
              + START_BYTES * bs * nt * nt)
    return dict(bytes=nbytes, ops=FACE_OPS * bs * nf, pairs=pairs)


def work(stretch):
    def one(key):
        faces, weights = stretch.faces_ndc(key)
        return binning_work(faces, stretch.size, weights)
    return stretch.per_call(one)


def read(rec):
    return trace.roofline_pct(rec, NAME, KERNELS)
