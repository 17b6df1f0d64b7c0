"""The work counts behind the roofline shares, on hand-made scenes."""

import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from neural_renderer_torch.rasterize import backward as program_backward  # noqa: E402,E501
from neural_renderer_torch.rasterize.config import RasterizeSettings  # noqa: E402,E501

from benchmark import roofline  # noqa: E402
from benchmark.reference import raster  # noqa: E402

IS = 16


def _ndc(px, py, z=2.0):
    """NDC face [3, 3] from pixel-space vertices."""
    return torch.tensor([[(2.0 * x + 1.0 - IS) / IS, (2.0 * y + 1.0 - IS) / IS,
                          z] for x, y in zip(px, py)])


ONE = _ndc([2.5, 9.5, 2.5], [2.5, 2.5, 11.5])           # front-facing
# two faces sharing the edge (9.5, 2.5)-(2.5, 11.5)
TWO = torch.stack([ONE, _ndc([9.5, 9.5, 2.5], [2.5, 11.5, 11.5])])


def _fim(faces):
    return raster.face_index_map(raster.Settings(IS), faces)


def test_least_seconds_takes_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 0)
    assert (t, by) == (1.0, 'bytes')
    t, by = roofline.least_seconds(0, 67e12 * 2)
    assert (t, by) == (2.0, 'operations')


def test_one_face():
    faces = ONE[None, None]
    # x from 2.5 to 9.5: pixels 3..9; y from 2.5 to 11.5: pixels 3..11
    assert roofline.box_pairs(faces, IS) == 7 * 9
    w = roofline.forward_work(faces, 2, IS, ('rgb', 'alpha', 'depth'))
    assert w['ops'] == 15 * 7 * 9
    assert w['bytes'] == 4 * 9 + 4 * 8 * 3 + 20 * IS * IS
    w = roofline.forward_work(faces, 2, IS, ('alpha',))
    assert w['bytes'] == 4 * 9 + 4 * IS * IS


def test_a_back_face_has_no_pairs():
    back = ONE[[0, 2, 1]][None, None]
    assert roofline.box_pairs(back, IS) == 0


def test_two_faces_sharing_an_edge():
    faces = TWO[None]
    assert roofline.box_pairs(faces, IS) == 7 * 9 + 7 * 9
    fim = _fim(faces)
    assert set(fim.unique().tolist()) == {-1, 0, 1}


@pytest.mark.parametrize('scene', ['one', 'two'])
@pytest.mark.parametrize('rgb,alpha', [(True, False), (False, True),
                                       (True, True)])
def test_outsweep_counts_match_the_programs_walk(scene, rgb, alpha):
    """Active crossings, swept positions and line pixels equal the
    program's own walk of the same map (another implementation)."""
    faces = (ONE[None, None] if scene == 'one' else TWO[None]).repeat(
        2, 1, 1, 1)
    fim = _fim(faces)
    got = roofline.outsweep_stats(faces, fim, IS)
    want = program_backward.out_sweep_stats(
        RasterizeSettings(image_size=IS), faces, fim)
    assert got['active'] > 0
    for k in ('active', 'positions', 'line_pixels'):
        assert got[k] == want[k]
    w = roofline.outsweep_work(faces, fim, IS, rgb, alpha)
    per = (11 if rgb and alpha else 8 if rgb else 2) + 1 + 8
    assert w['ops'] == per * got['positions']
    nf = faces.shape[1]
    plane = 24 * rgb + 8 * alpha
    assert w['bytes'] == (4 * 2 * IS * IS + 4 * 2 * nf * 6
                          + plane * got['line_pixels'] + 4 * 2 * nf * 9)


def test_an_empty_view():
    """Faces behind the near plane and off screen: nothing to draw or
    sweep."""
    faces = torch.stack([_ndc([2.5, 9.5, 2.5], [2.5, 2.5, 11.5], z=0.05),
                         ONE + torch.tensor([5.0, 0.0, 0.0])])[None]
    fim = _fim(faces)
    assert (fim == -1).all()
    assert roofline.box_pairs(faces[:, 1:], IS) == 0
    st = roofline.outsweep_stats(faces, fim, IS)
    assert st == dict(active=0, positions=0, line_pixels=0)


def test_weights_stand_for_repeated_elements():
    """Counting distinct elements once, each with its number as a weight,
    gives the counts of the whole batch."""
    two = TWO[None]
    one = torch.cat([ONE[None], ONE[None] + 0.3])[None]
    batch = torch.cat([two, one, two, two])
    fim = _fim(batch)
    distinct = torch.cat([two, one])
    weights = torch.tensor([3, 1])
    dfim = _fim(distinct)
    for f in (lambda fc, w: roofline.forward_work(fc, 2, IS, ('rgb',), w),
              lambda fc, w: roofline.outsweep_work(
                  fc, fim if w is None else dfim, IS, True, False, w)):
        assert f(batch, None) == f(distinct, weights)
