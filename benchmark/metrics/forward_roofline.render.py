"""The forward's share of its roofline, in %: the least time of what a
call's raster needs (``roofline.forward_work``) over the device time per
call of the forward's kernels, the setup and binning with the shaded
kernel."""

from benchmark import roofline, trace

NAME = 'forward_roofline.render'
KERNELS = ('shaded_kernel', 'bin_count_kernel', 'bin_fill_kernel',
           'DeviceScan')


def work(stretch):
    ts = stretch.cfg['texture_size']

    def one(key):
        faces, weights = stretch.faces_ndc(key)
        return roofline.forward_work(faces, ts, stretch.size,
                                     stretch.outputs, weights)
    return stretch.per_call(one)


def read(rec):
    return trace.roofline_pct(rec, NAME, KERNELS)
