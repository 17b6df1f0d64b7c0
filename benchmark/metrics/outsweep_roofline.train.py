"""The out-sweep's share of its roofline, in %: the least time of the
crossings on the reference's face-index map (``roofline.outsweep_work``)
over the out-sweep kernel's device time per step."""

from benchmark import roofline, trace

NAME = 'outsweep_roofline.train'
KERNELS = ('outsweep_kernel',)
# batch elements per block of the reference's face-index map
BLOCK = 8


def work(stretch):
    def one(key):
        faces, weights = stretch.faces_ndc(key)
        return roofline.outsweep_work(
            faces, stretch.face_index(key, BLOCK), stretch.size,
            'rgb' in stretch.outputs, 'alpha' in stretch.outputs, weights)
    return stretch.per_call(one)


def read(rec):
    return trace.roofline_pct(rec, NAME, KERNELS)
