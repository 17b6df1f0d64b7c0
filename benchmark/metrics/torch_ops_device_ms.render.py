"""Device ms per call of the kernels outside the program's hand-written
ones (the plain torch around them), in the traced stretch."""

from benchmark import trace

# the program's hand-written kernels (the __global__ functions of
# neural_renderer_torch/csrc/*.cu, and CUB's scan, which csrc/bin_faces.cu
# launches): everything else on the device is plain torch
KERNELS = ('shaded_kernel', 'index_kernel', 'insweep_kernel',
           'outsweep_kernel', 'bin_count_kernel', 'bin_fill_kernel',
           'DeviceScan', 'face_reduce_tile_kernel', 'face_reduce_face_kernel',
           'segment_sum_kernel')


def read(rec):
    s = trace.kernel_seconds(rec, KERNELS, exclude=True)
    return None if s is None else s * 1e3 / rec['calls']
