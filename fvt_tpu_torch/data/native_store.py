"""ctypes binding for the native feature-store gather: the port's copy of
``fvt_tpu/data/native_store.py`` over its own copy of the C++ source,
``fvt_tpu_torch/native/fvt_store.cpp``.

Parses the .npy v1/v2 header once per file (cached), then gathers window
rows through the C library (GIL released -> the loader's thread pool gets
real parallelism).  Falls back to numpy mmap when the library is absent.
:func:`ensure_built` compiles it with ``g++`` into ``build/`` at the
repository root (the directory the CUDA kernels are built in), under a
name keyed by a hash of the source and the flags; the CLIs call it at
start-up, and nothing on the loader's path ever compiles.
"""
from __future__ import annotations

import ast
import ctypes
import hashlib
import os
import struct
import subprocess
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, 'native', 'fvt_store.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), 'build')
# x86-64-v3 (AVX2 + FMA), as native/Makefile builds the original
CXXFLAGS = ('-O3', '-march=x86-64-v3', '-funroll-loops', '-fPIC',
            '-std=c++17', '-Wall', '-pthread', '-shared')

_lib = None
_load_attempted = False


def library_path() -> str:
    h = hashlib.sha256(' '.join(CXXFLAGS).encode())
    with open(SOURCE, 'rb') as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f'libfvt_store-{h.hexdigest()[:16]}.so')


def _load_lib():
    """CDLL an already-built library.  Never compiles — the loader hot
    path must not have a subprocess side effect; build explicitly with
    ``ensure_built()`` (the CLIs call it at startup)."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    path = library_path()
    if not os.path.isfile(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.fvt_gather_rows.restype = ctypes.c_int
    lib.fvt_gather_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.fvt_gather_resize_u8.restype = ctypes.c_int
    lib.fvt_gather_resize_u8.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    _lib = lib
    return lib


def ensure_built() -> bool:
    """Compiles the library if ``build/`` lacks it and loads it.  Returns
    True when the native gather is usable.  The library is written under a
    per-process temporary name and renamed into place, so concurrent
    builds and running processes that map an older one never see a
    half-written file.  If the build fails (no ``g++``), the loaders keep
    the numpy path."""
    global _load_attempted
    path = library_path()
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        try:
            subprocess.run(['g++', *CXXFLAGS, '-o', tmp, SOURCE],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError):
            pass  # the numpy path stays
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    _load_attempted = False
    return _load_lib() is not None


def available() -> bool:
    return _load_lib() is not None


def npy_header(path: str) -> Tuple[int, Tuple[int, ...], np.dtype, bool]:
    """(data_offset, shape, dtype, fortran_order) of a .npy file.

    Cached per (path, mtime, size) so in-place rewrites — e.g.
    faces.compact_video_npy truncating video.npy — invalidate the entry
    instead of serving a stale shape."""
    st = os.stat(path)
    return _npy_header(path, st.st_mtime_ns, st.st_size)


@lru_cache(maxsize=4096)
def _npy_header(path: str, mtime_ns: int, size: int
                ) -> Tuple[int, Tuple[int, ...], np.dtype, bool]:
    with open(path, 'rb') as f:
        magic = f.read(6)
        assert magic == b'\x93NUMPY', path
        major, minor = f.read(2)
        if major == 1:
            (hlen,) = struct.unpack('<H', f.read(2))
            offset = 10 + hlen
        else:
            (hlen,) = struct.unpack('<I', f.read(4))
            offset = 12 + hlen
        header = f.read(hlen).decode('latin1')
    meta = ast.literal_eval(header)
    return (offset, tuple(meta['shape']), np.dtype(meta['descr']),
            bool(meta['fortran_order']))


def gather_rows(path: str, indices: np.ndarray,
                num_threads: int = 4) -> Optional[np.ndarray]:
    """Rows ``indices`` of the 2+D array at ``path``; None if the native
    path is unavailable for this file."""
    lib = _load_lib()
    if lib is None:
        return None
    offset, shape, dtype, fortran = npy_header(path)
    if fortran or len(shape) < 1:
        return None
    row_elems = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 \
        else 1
    row_bytes = row_elems * dtype.itemsize

    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= shape[0]):
        # degrade like every other failure path (the C side validates
        # too and returns -3); an assert would raise inside loader
        # worker threads and vanish under python -O
        return None
    out = np.empty((idx.size,) + shape[1:], dtype=dtype)
    rc = lib.fvt_gather_rows(
        path.encode(), offset, row_bytes,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idx.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    if rc != 0:
        return None
    return out


def gather_resize_rows(path: str, indices: np.ndarray, size: int,
                       num_threads: int = 1,
                       crop: Optional[int] = None) -> Optional[np.ndarray]:
    """Fused frame gather + antialiased-bilinear resize to (size, size)
    for a (N, H, W, C) uint8 .npy — the challenge-inference hot path.

    Same triangle kernel as data/host_resize.py (weights shared), walked
    band-limited in C straight off the mmap with the GIL released; the
    uint8 rounding matches resize_frames_uint8 up to fp32 summation
    order (<= 1 lsb on exact .5 ties).  None -> caller falls back to
    gather + resize_frames_uint8.

    ``crop`` (eval's deterministic center crop, the upstream
    base/transforms3D.py GroupCenterCrop) fuses the crop INTO the
    resize by handing the C kernel only the central ``crop`` rows of
    each (size, dim) weight matrix: crop-after-round equals
    round-after-crop for a row selection, so the output is bit-identical
    to ``gather_resize_rows(...)[:, off:off+crop, off:off+crop]`` while
    skipping the cropped pixels' FLOPs and the extra host copy.
    Output shape is then (n, crop, crop, C).
    """
    lib = _load_lib()
    if lib is None:
        return None
    offset, shape, dtype, fortran = npy_header(path)
    if fortran or len(shape) != 4 or dtype != np.uint8:
        return None
    n_disk, h, w, c = shape
    if h == size and w == size:
        return None  # already at target size: plain gather is cheaper
    if crop is not None and not 0 < crop < size:
        crop = None  # degenerate crop: plain resize

    from fvt_tpu_torch.data.host_resize import resize_weights
    wh = np.ascontiguousarray(resize_weights(h, size))
    ww = np.ascontiguousarray(resize_weights(w, size))
    if crop is not None:
        from fvt_tpu_torch.data.transforms import center_crop_offset
        off = center_crop_offset(size, crop)
        wh = np.ascontiguousarray(wh[off:off + crop])
        ww = np.ascontiguousarray(ww[off:off + crop])
        size = crop

    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n_disk):
        # out-of-range indices degrade to None like every other failure
        # path here (the C side validates too and returns -3); an assert
        # would raise inside loader worker threads and vanish under -O
        return None
    out = np.empty((idx.size, size, size, c), dtype=np.uint8)
    rc = lib.fvt_gather_resize_u8(
        path.encode(), offset,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idx.size,
        h, w, c, size,
        wh.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ww.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    if rc != 0:
        return None
    return out
