"""The work count behind ``tex_scatter_roofline.ts16``
(``benchmark/metrics/tex_scatter_roofline.ts16.py``) against hand counts
on hand-made face-index maps, and its reader on hand-made device records."""

import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, roofline  # noqa: E402

METRIC = harness.reader('tex_scatter_roofline.ts16')
IS = 8


def _fim(covered_per_element, nf=3):
    """A ``[bs, IS, IS]`` face-index map whose element ``b`` covers its
    first ``covered_per_element[b]`` pixels in row-major order, with faces
    ``0 .. nf - 1`` in turn; -1 elsewhere."""
    out = torch.full((len(covered_per_element), IS * IS), -1,
                     dtype=torch.int32)
    for b, n in enumerate(covered_per_element):
        out[b, :n] = torch.arange(n, dtype=torch.int32) % nf
    return out.reshape(-1, IS, IS)


@pytest.mark.parametrize('ts', [5, 16])
def test_counts_by_hand(ts):
    fim = _fim([10, 0, IS * IS])
    covered = 10 + IS * IS
    w = METRIC.tex_scatter_work(fim, 3, ts)
    assert w['covered'] == covered
    assert w['bytes'] == (40 * covered + 4 * 3 * IS * IS
                          + 4 * 3 * 3 * ts ** 3 * 3)
    assert w['ops'] == 64 * covered


def test_uncovered_map_counts_the_cube_and_the_map_alone():
    w = METRIC.tex_scatter_work(_fim([0, 0]), 4928, 16)
    assert w == dict(bytes=4 * 2 * IS * IS + 4 * 2 * 4928 * 4096 * 3, ops=0,
                     covered=0)


def test_weights_stand_for_repeated_elements():
    whole = METRIC.tex_scatter_work(_fim([7, 7, 7, 20]), 3, 16)
    weighted = METRIC.tex_scatter_work(_fim([7, 20]), 3, 16,
                                       torch.tensor([3, 1]))
    assert whole == weighted
    assert whole['covered'] == 3 * 7 + 20


def test_the_cell_binds_on_bytes():
    """At the cell's shape (bs 32, 4,928 faces after fill_back, ts 16, a
    512^2 raster) the cube written once binds, whatever the coverage."""
    for covered in (0, 32 * 512 * 512):
        nbytes = (40 * covered + 4 * 32 * 512 * 512
                  + 4 * 32 * 4928 * 16 ** 3 * 3)
        _, by = roofline.least_seconds(nbytes, 64 * covered)
        assert by == 'bytes'


def _rec(names, calls=2):
    work = {METRIC.NAME: dict(bytes=3.35e9, ops=0, covered=0)}
    return dict(calls=calls, work=work,
                device=[(n, 0.0, 500.0, 'kernel') for n in names])


def test_read_none_without_a_matching_kernel():
    assert METRIC.read(_rec([])) is None
    assert METRIC.read(_rec(['outsweep_kernel', 'elementwise_kernel'])) \
        is None


def test_read_times_the_matching_kernels():
    """Each named kernel runs 0.5 ms in the stretch of 2 calls: the sort's,
    the search's, the segmented sum's and a later ``tex_scatter`` kernel's
    count, the rest does not; 1 ms of least time a call."""
    names = ['DeviceRadixSortOnesweepKernel', 'searchsorted_cuda_kernel',
             'segment_sum_kernel', 'tex_scatter_kernel', 'elementwise_kernel']
    assert METRIC.read(_rec(names)) == pytest.approx(100.0 * 1e-3 / 1e-3)
    assert METRIC.read(_rec(names[:2])) == pytest.approx(200.0)
