"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  At first use it
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library inside
the package's ``_build/`` directory (listed in ``.gitignore``) and loaded
with ``ctypes``.  The library's file name carries a hash of the source, of
the headers beside it (``csrc/*.cuh``) and of the flags, so an edited source
or header is rebuilt and a built one is reused.

Host code under ``csrc/`` (``*.cpp``: the OBJ parser) is built the same
way by ``g++`` (``build_host``).

Flags: ``--fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise kernels round them, so the kernels agree with their
plain PyTorch versions bit for bit; without it a fused multiply-add in an
edge test or a barycentric weight can flip a near-tie z test.  Fast math is
never used: ``1/z`` and the depth divisions stay IEEE.
"""

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

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


def build(name):
    """``build_all`` for one kernel source: (library path, nvcc's output or
    '' when reused)."""
    return build_all([name])[name]


def load(name):
    """The ctypes handle of kernel library ``name``, built at first use."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


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
