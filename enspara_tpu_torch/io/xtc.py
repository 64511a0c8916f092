"""GROMACS XTC read/write via the native codec
(enspara_tpu_torch/native/xdr.cpp), with ctypes bindings."""

import ctypes

import numpy as np

from ..exception import MissingData
from ..native import load_library

__all__ = ['load_xtc', 'write_xtc', 'scan_xtc']

_lib = None
_checked = False
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def _get_lib():
    global _lib, _checked
    if not _checked:
        _lib = load_library('xdr')
        if _lib is not None:
            _lib.xtc_scan.restype = ctypes.c_long
            _lib.xtc_scan.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long)]
            _lib.xtc_read.restype = ctypes.c_long
            _lib.xtc_read.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                _FP, _FP, _FP, _IP]
            _lib.xtc_write.restype = ctypes.c_long
            _lib.xtc_write.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                _FP, _FP, _FP, _IP, ctypes.c_float]
        _checked = True
    if _lib is None:
        raise MissingData(
            'Native XTC codec unavailable (g++ build failed); cannot '
            'read/write .xtc files.')
    return _lib


def scan_xtc(filename):
    """(n_frames, n_atoms) without decoding coordinates."""
    lib = _get_lib()
    nf = ctypes.c_long()
    na = ctypes.c_long()
    if lib.xtc_scan(str(filename).encode(), ctypes.byref(nf),
                    ctypes.byref(na)) != 0:
        raise MissingData('Could not open XTC file %s' % filename)
    return nf.value, na.value


def load_xtc(filename, top=None, stride=None, atom_indices=None,
             frame=None):
    """Load an XTC file -> Trajectory (requires a topology)."""
    from .trajectory import Trajectory

    n_frames, n_atoms = scan_xtc(filename)
    if n_frames == 0:
        raise MissingData('No frames in XTC file %s' % filename)

    xyz = np.empty((n_frames, n_atoms, 3), np.float32)
    box = np.empty((n_frames, 3, 3), np.float32)
    time = np.empty(n_frames, np.float32)
    step = np.empty(n_frames, np.int32)

    lib = _get_lib()
    got = lib.xtc_read(str(filename).encode(), n_atoms, n_frames,
                       xyz.ctypes.data_as(_FP), box.ctypes.data_as(_FP),
                       time.ctypes.data_as(_FP),
                       step.ctypes.data_as(_IP))
    xyz = xyz[:got]
    box = box[:got]
    time = time[:got]

    if frame is not None:
        sl = slice(frame, frame + 1)
    elif stride is not None and stride > 1:
        sl = slice(None, None, stride)
    else:
        sl = slice(None)
    xyz, box, time = xyz[sl], box[sl], time[sl]

    from .trajectory import _resolve_top
    traj = Trajectory(xyz, _resolve_top(top), time=time,
                      unitcell_vectors=box)
    if atom_indices is not None:
        traj = traj.atom_slice(atom_indices)
    return traj


def write_xtc(filename, traj, precision=1000.0):
    """Write a Trajectory to XTC."""
    lib = _get_lib()
    xyz = np.ascontiguousarray(traj.xyz, np.float32)
    n_frames, n_atoms = xyz.shape[:2]
    if traj.unitcell_vectors is not None:
        box = np.ascontiguousarray(traj.unitcell_vectors, np.float32)
    else:
        box = np.tile(np.eye(3, dtype=np.float32), (n_frames, 1, 1))
    time = np.ascontiguousarray(
        traj.time if traj.time is not None
        else np.arange(n_frames, dtype=np.float32), np.float32)
    step = np.arange(n_frames, dtype=np.int32)
    got = lib.xtc_write(str(filename).encode(), n_atoms, n_frames,
                        xyz.ctypes.data_as(_FP),
                        box.ctypes.data_as(_FP),
                        time.ctypes.data_as(_FP),
                        step.ctypes.data_as(_IP),
                        ctypes.c_float(precision))
    if got != n_frames:
        raise IOError('Failed writing %s' % filename)
    return filename
