"""Native (C++) host kernels: the XTC codec (``xdr.cpp``) and the Prinz
MLE (``prinz.cpp``).

At first use ``<name>.cpp`` is compiled with g++ into the package's
``build/`` directory as ``lib<name>-<hash>.so``, the hash taken over
the source and the flags, and loaded with ``ctypes``. Each build writes
to a private temporary name and is renamed into place, so a thread or
process that races another to build the same library never loads a
half-written file. Every consumer has a pure-Python fallback or raises
a clear error when no library can be built.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile

logger = logging.getLogger(__name__)

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), 'build')
# no -march=native: the build directory may be copied to another
# machine, and a library tuned to this host's CPU would not run there
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17')


def lib_path(name):
    """``(source, library path)`` of ``<name>.cpp``."""
    src = os.path.join(NATIVE_DIR, '%s.cpp' % name)
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    with open(src, 'rb') as fh:
        digest.update(fh.read())
    return src, os.path.join(BUILD_DIR, 'lib%s-%s.so'
                             % (name, digest.hexdigest()[:16]))


def _build(cxx, src, path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name):
    """ctypes-load the library of ``<name>.cpp``, compiling it first if
    needed. Returns None when there is no source or no toolchain."""
    cxx = os.environ.get('CXX') or 'g++'
    if not os.path.exists(os.path.join(NATIVE_DIR, '%s.cpp' % name)) \
            or shutil.which(cxx) is None:
        return None
    src, path = lib_path(name)
    if not os.path.exists(path):
        try:
            _build(cxx, src, path)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning('Could not build native lib%s.so (%s); '
                           'using pure-Python fallback.', name, e)
            return None
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        logger.warning('Could not load %s (%s); using pure-Python '
                       'fallback.', path, e)
        return None
