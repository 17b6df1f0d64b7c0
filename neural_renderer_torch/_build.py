"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  At first use it
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library inside
the package's ``_build/`` directory (listed in ``.gitignore``) and loaded
with ``ctypes``.  The library's file name carries a hash of the source, of
the headers beside it (``csrc/*.cuh``) and of the flags, so an edited source
or header is rebuilt and a built one is reused.

Host code under ``csrc/`` (``*.cpp``: the OBJ parser) is built the same
way by ``g++`` (``build_host``).

This is the one module that knows how a kernel library is loaded and how
its entry points are called: ``LIBRARIES`` holds every library's C
signatures, ``library`` loads one with them declared, and ``launch``
calls an entry point on the current stream of a tensor's device, raises
on a CUDA error and counts the launch (``tracing``).  A test fakes a card
launch on the CPU by patching ``library``, ``current_device`` and
``raw_stream`` here.

Flags: ``--fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise kernels round them, so the kernels agree with their
plain PyTorch versions bit for bit; without it a fused multiply-add in an
edge test or a barycentric weight can flip a near-tie z test.  Fast math is
never used: ``1/z`` and the depth divisions stay IEEE.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from neural_renderer_torch import tracing

# the C types of the kernels' interfaces
PTR, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SWEEP = (PTR, PTR, PTR, ctypes.POINTER(I64), PTR, ctypes.POINTER(I64), PTR,
          I32, I32, F32, PTR, I64)
# every kernel library under csrc/ with the C signatures of its entry
# points: {library: {entry point: (restype, argtypes)}}
LIBRARIES = {
    'forward_shaded': {
        'nr_forward_shaded':
            (I32, (PTR,) * 4 + (I32,) * 4 + (F32,) * 3 + (PTR,) * 7),
        'nr_forward_shaded_tile': (I32, ())},
    'forward_index': {
        'nr_forward_index':
            (I32, (PTR,) * 3 + (I32,) * 3 + (F32,) * 2 + (PTR,) * 3),
        'nr_forward_index_tile': (I32, ())},
    'bin_faces': {
        'nr_bin_cells': (I64, (I32,) * 4),
        'nr_bin_scan_bytes': (I64, (I32,) * 4),
        'nr_bin_count': (I32, (PTR,) + (I32,) * 4 + (PTR,) * 8 + (I64, PTR)),
        'nr_bin_fill': (I32, (PTR,) * 3 + (I32,) * 5 + (PTR,) * 5)},
    'backward_sweeps': {
        'nr_insweep': (I32, _SWEEP + (PTR,)),
        'nr_outsweep': (I32, _SWEEP + (I32, I32, I32, PTR)),
        'nr_outsweep_smem_limit': (I32, ())},
    'face_reduce': {
        'nr_face_reduce': (I32, (PTR,) * 6 + (I32,) * 5
                           + (ctypes.POINTER(PTR), ctypes.POINTER(I64), F32)
                           + (PTR,) * 3),
        'nr_face_grad': (I32, (PTR, I64, I64, I32, I32, PTR, PTR)),
        'nr_face_reduce_tile': (I32, ())},
    'composite_pool': {
        'nr_composite_pool':
            (I32, (PTR,) * 4 + (I32,) * 3 + (I64, I32, I32) + (PTR,) * 4)},
    'segment_sum': {
        'nr_segment_sum': (I32, (PTR,) * 3 + (I64, I64, I32, PTR, PTR))},
    'tex_scatter': {
        'nr_tex_scatter': (I32, (PTR,) * 5 + (I32,) * 5
                           + (ctypes.POINTER(PTR), ctypes.POINTER(I64), F32,
                              PTR, I64, PTR)),
        'nr_tex_scatter_tile': (I32, ())},
}

_CSRC = pathlib.Path(__file__).resolve().parent / 'csrc'
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / '_build'
_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '--fmad=false', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError(
            'nvcc not found (neither on PATH nor under CUDA_HOME or '
            '/usr/local/cuda): the CUDA kernels cannot be built')
    return path


_HOST_FLAGS = ('-O2', '-shared', '-fPIC')


def _target(name, suffix='.cu', flags=_FLAGS, headers='*.cuh'):
    src = _CSRC / f'{name}{suffix}'
    head = b''.join(h.read_bytes() for h in sorted(_CSRC.glob(headers)))
    digest = hashlib.sha256(src.read_bytes() + head
                            + ' '.join(flags).encode()).hexdigest()[:16]
    return src, _BUILD_DIR / f'lib{name}-{digest}.so'


def build_host(name):
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` into the
    build directory (reused while the source and flags are unchanged) and
    return the library's path; raises if ``g++`` is missing or fails."""
    src, lib = _target(name, '.cpp', _HOST_FLAGS, '*.h')
    if lib.exists():
        return lib
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ not found: cannot build ' + str(src))
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([gxx, *_HOST_FLAGS, '-o', str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed to build {src}:\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib


def build_all(names):
    """Compile ``csrc/<name>.cu`` for every name that has no up-to-date
    build, one ``nvcc`` process each, all started together.

    Returns {name: (path of the shared library, nvcc's output or '' when
    reused)}; raises if any build fails (after all have finished).
    """
    started = {}
    done = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            done[name] = (lib, '')
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
        proc = subprocess.Popen([_nvcc(), *_FLAGS, '-o', str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (src, lib, tmp, proc)
    failed = []
    for name, (src, lib, tmp, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed to build {src}:\n{log}')
            continue
        os.replace(tmp, lib)
        done[name] = (lib, log)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return done


@functools.cache
def library(name):
    """The ctypes handle of kernel library ``name``, built at first use,
    with the C signatures of its entry points (``LIBRARIES``) and
    ``nr_error_string``, which every library exports, declared.  Loaded
    once."""
    lib = ctypes.CDLL(str(build_all([name])[name][0]))
    for entry, (restype, argtypes) in LIBRARIES[name].items():
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = restype, argtypes
    lib.nr_error_string.restype = ctypes.c_char_p
    lib.nr_error_string.argtypes = (I32,)
    return lib


def raise_on_error(lib, rc, name):
    """Raise if launcher ``name`` of ``lib`` returned CUDA error ``rc``
    (its library's ``nr_error_string`` names it)."""
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: '
                           + lib.nr_error_string(rc).decode())


def current_device(index):
    """The CUDA device context for a launch on device ``index``: none where
    it is already the current device."""
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def raw_stream(index):
    """The current stream of CUDA device ``index`` as the ``cudaStream_t``
    a kernel's C interface takes, without making a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def call(lib, entry, index, *args):
    """``lib.<entry>(*args, stream)`` on CUDA device ``index``, entered
    only where it is not the current device, with its current stream last;
    raises, naming ``entry``, where the entry point returns a CUDA error."""
    with current_device(index):
        rc = getattr(lib, entry)(*args, raw_stream(index))
    raise_on_error(lib, rc, entry)


def launch(lib, kernel, index, *args, entry=None):
    """``call`` of ``entry`` (``nr_<kernel>`` when None), counted once as
    ``tracing.COUNTS['launch.<kernel>']``."""
    call(lib, entry or 'nr_' + kernel, index, *args)
    tracing.COUNTS['launch.' + kernel] += 1


def ptr(t):
    """The device address of tensor ``t``, or None (a null pointer)."""
    return None if t is None else t.data_ptr()
