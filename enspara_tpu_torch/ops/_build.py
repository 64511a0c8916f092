"""Build and load the package's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; the
``csrc/*.cuh`` headers hold device code the kernels share. At first use
a kernel is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under the package's ``build/`` directory and loaded with
``ctypes``; pointers and the stream pass as ``ctypes.c_void_p``. The
library's file name carries a hash of the source, the headers and the
flags, so an edited source is rebuilt and an unchanged one is reused.

There is no fallback: without ``nvcc`` or on a failed build this
raises, and the caller's CUDA path fails with it.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ['NVCC_FLAGS', 'build', 'find_nvcc', 'load_library']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')

# no --use_fast_math: it changes the rounding of division and sqrt
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC')


def find_nvcc():
    """Path of ``nvcc``: on ``PATH``, else ``$CUDA_HOME/bin/nvcc``
    (``CUDA_HOME`` defaults to ``/usr/local/cuda``)."""
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(
        'nvcc not found (searched PATH and %s): the CUDA kernels of '
        'enspara_tpu_torch are compiled from enspara_tpu_torch/csrc at '
        'first use and need the CUDA toolkit; set CUDA_HOME or put nvcc '
        'on PATH' % candidate)


def _lib_path(name):
    src = os.path.join(CSRC_DIR, name + '.cu')
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh'))):
        with open(path, 'rb') as fh:
            digest.update(fh.read())
    return src, os.path.join(BUILD_DIR, 'lib%s-%s.so'
                             % (name, digest.hexdigest()[:16]))


def build(*names):
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` per source, all started together. Raises ``RuntimeError``
    when ``nvcc`` is missing or a build fails."""
    todo = [(src, lib) for src, lib in map(_lib_path, names)
            if not os.path.exists(lib)]
    if not todo:
        return
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    try:
        for src, lib in todo:
            # build to a private name, then rename: concurrent builders
            # of the same source never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
            os.close(fd)
            jobs.append((src, lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-o', tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, lib, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append('nvcc failed to build %s (exit %d):\n%s'
                              % (src, proc.returncode, err[-4000:]))
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError('\n'.join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load_library(name):
    """Compile ``csrc/<name>.cu`` if needed and return the loaded
    ``ctypes.CDLL``. Raises ``RuntimeError`` when ``nvcc`` is missing
    or the build fails."""
    build(name)
    return ctypes.CDLL(_lib_path(name)[1])
