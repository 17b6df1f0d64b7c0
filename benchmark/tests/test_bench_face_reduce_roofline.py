"""The work count behind ``face_reduce_roofline.ts4``
(``benchmark/metrics/face_reduce_roofline.ts4.py``) against a hand count
on a two-face scene at a 16^2 raster."""

import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402
from benchmark.reference import raster  # noqa: E402

IS = 16
METRIC = harness.reader('face_reduce_roofline.ts4')


def _ndc(px, py, z=2.0):
    """NDC face [3, 3] from pixel-space vertices."""
    return torch.tensor([[(2.0 * x + 1.0 - IS) / IS, (2.0 * y + 1.0 - IS) / IS,
                          z] for x, y in zip(px, py)])


# two front-facing right triangles apart, their hypotenuses through no
# pixel centre: centres (x, y) with x, y >= 3 and x + y <= 11 (21), and
# with x >= 11, y >= 5 and x + y <= 19 (10)
TWO = torch.stack([_ndc([2.5, 9.0, 2.5], [2.5, 2.5, 9.0]),
                   _ndc([10.5, 15.0, 10.5], [4.5, 4.5, 9.0])])
COVERED = 21 + 10


def _fim(faces):
    return raster.face_index_map(raster.Settings(IS), faces)


@pytest.mark.parametrize('ts,c_in,c_out,per_pixel', [
    (4, 12 + 23, 12 + 192, 12 + 3 * 192),
    (2, 12 + 9, 12 + 24, 12 + 3 * 24)])
def test_two_faces_by_hand(ts, c_in, c_out, per_pixel):
    faces = TWO[None]
    fim = _fim(faces)
    assert int((fim == 0).sum()) == 21 and int((fim == 1).sum()) == 10
    w = METRIC.face_reduce_work(fim, 2, ts)
    assert w['covered'] == COVERED
    assert w['bytes'] == 4 * COVERED * c_in + 4 * IS * IS + 4 * 2 * c_out
    assert w['ops'] == COVERED * per_pixel


def test_weights_stand_for_repeated_elements():
    one = TWO[None, :1]
    batch = torch.cat([TWO[None], one.repeat(1, 2, 1, 1), TWO[None]])
    distinct = torch.cat([TWO[None], one.repeat(1, 2, 1, 1)])
    whole = METRIC.face_reduce_work(_fim(batch), 2, 4)
    weighted = METRIC.face_reduce_work(_fim(distinct), 2, 4,
                                       torch.tensor([2, 1]))
    assert whole == weighted
    assert whole['covered'] == 2 * COVERED + 21

