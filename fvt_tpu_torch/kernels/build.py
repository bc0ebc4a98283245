"""Builds the port's CUDA kernels into one shared library and binds it.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one compiler process per source and all of them at once, and linked into
``build/libfvt_tpu_torch-<hash>.so`` at the repository root, keyed by a
hash of the sources, their ``*.cuh`` headers and the flags, at the first
call that needs a
kernel.  The library has a plain C interface and is loaded with
``ctypes``: every pointer and the stream pass as ``c_void_p``, every C
entry returns the CUDA error code of its launch, and :func:`check` raises
on a non-zero code.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR.parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry -> argument types; every entry returns an int
_SIGNATURES = {
    # x w1 b1 w2 b2 wd bd out, B T Cin Cout K dil, stream
    'fvt_tcn_block_forward': [_P] * 8 + [_I] * 6 + [_P],
    # x w1_hi w1_lo b1 w2_hi w2_lo b2 wd_hi wd_lo bd h r y (fp32), B T C
    # Cout K dil stages, stream
    'fvt_tcn_block_tf32x3_forward': [_P] * 13 + [_I] * 7 + [_P],
    # (x[M] w[M] b[M]) c[M] (host arrays), wo bo ln_w ln_b out, N M E H
    # route, stream
    'fvt_fusion_forward': [_P] * 7 + [_I] * 5 + [_P],
    # (x[M] w_hi[M] w_lo[M] b[M]) c[M] (host arrays), wo_hi wo_lo bo ln_w
    # ln_b out ws, ws_blocks N M E H, stream
    'fvt_fusion_tf32x3_forward': [_P] * 9 + [_I] * 5 + [_P],
    # x w1 b1 w2 b2 m1 m2 res a1 a2 out, B T Cin Cout K dil, stream
    'fvt_tcn_block_train_forward': [_P] * 11 + [_I] * 6 + [_P],
    # x w1 w2 m1 m2 res a1 a2 g, d_a2 d_a1 part1 part2, dx dw1 db1 dw2 db2
    # dres, B T Cin Cout K dil S1 S2, stream
    'fvt_tcn_block_train_backward': [_P] * 19 + [_I] * 8 + [_P],
    # x w1 b1 w2 b2 m1 m2 res, w1_hi w1_lo w2_hi w2_lo, a1 h a2 out, B T
    # Cin Cout K dil stages, stream
    'fvt_tcn_block_train_tf32x3_forward': [_P] * 16 + [_I] * 7 + [_P],
    # x w1 w2 m1 m2 res a1 h a2 g, d_a2 d_a1 w1t_hi w1t_lo w2t_hi w2t_lo
    # part1 part2, dx dw1 db1 dw2 db2 dres, B T Cin Cout K dil S1 S2
    # stages, stream
    'fvt_tcn_block_train_tf32x3_backward': [_P] * 24 + [_I] * 9 + [_P],
    # x w y, N H W C Co, tf th tw, stream
    'fvt_conv3x3_forward': [_P] * 3 + [_I] * 8 + [_P],
    # x wp y (bf16), N H W C Co bn, stream
    'fvt_conv3x3_bf16_forward': [_P] * 3 + [_I] * 6 + [_P],
    # x w_hi w_lo y (fp32), N H W C Co bn, stream
    'fvt_conv3x3_tf32x3_forward': [_P] * 4 + [_I] * 6 + [_P],
    # x u y, N H W C Co, stream
    'fvt_winograd_forward': [_P] * 3 + [_I] * 5 + [_P],
    # x u_hi u_lo v m y (fp32), N H W C Co bn stages, stream
    'fvt_winograd_tf32x3_forward': [_P] * 6 + [_I] * 7 + [_P],
    # x up v y (bf16), N H W C Co stages, stream
    'fvt_winograd_bf16_forward': [_P] * 4 + [_I] * 6 + [_P],
    # x up y (bf16), N H W C Co, stream
    'fvt_winograd_bf16_fused_forward': [_P] * 3 + [_I] * 5 + [_P],
    # x w1 w2 a1 b1 alpha a2 b2 y, N H W C, tf th tw rg, stream
    'fvt_bottleneck_forward': [_P] * 9 + [_I] * 8 + [_P],
    # x w1_hi w1_lo w2_hi w2_lo a1 b1 alpha a2 b2 v y (fp32), N H W C bn
    # stages, stream
    'fvt_bottleneck_tf32x3_forward': [_P] * 12 + [_I] * 6 + [_P],
    # x w1p w2p (bf16) a1 b1 alpha a2 b2 (fp32) v y (bf16), N H W C bn
    # stages, stream
    'fvt_bottleneck_bf16_forward': [_P] * 10 + [_I] * 6 + [_P],
    # x w1p w2p (bf16) a1 b1 alpha a2 b2 (fp32) v y (bf16), N H W C stages,
    # stream
    'fvt_bottleneck_bf16_wgmma_forward': [_P] * 10 + [_I] * 5 + [_P],
    # x, bf16, n, amax scale_in scale_out q, stream
    'fvt_quantize_int8': [_P, _I, ctypes.c_longlong] + [_P] * 5,
    # x, bf16, n, C prologue, p0 p1 p2 scale_in words q, stream
    'fvt_quantize_int8_fused': [_P, _I, ctypes.c_longlong, _I, _I]
    + [_P] * 7,
    # xq wp (packed) wscale xscale y, bf16_out N H W C Co stride, stream
    'fvt_conv3x3_s8_forward': [_P] * 5 + [_I] * 7 + [_P],
    # xq wq wscale xscale y, bf16_out N H W C Co stride, stream
    'fvt_conv3x3_s8_mma_forward': [_P] * 5 + [_I] * 7 + [_P],
}


def sources() -> list:
    return sorted(CSRC_DIR.glob('*.cu'))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    the ``PATH``."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.access(os.path.join(home, 'bin', 'nvcc'), os.X_OK):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of fvt_tpu_torch '
                           'are built with the CUDA toolkit')
    return found


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libfvt_tpu_torch-{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compiles the sources unless the library for their hash exists.
    The compiler's report (registers, spills, shared memory) is kept
    beside the library as ``<name>.log``.  Returns the library's path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, src.stem + '.o') for src in sources()]
        cmds = [[nvcc(), *NVCC_FLAGS, '-c', '-o', obj, str(src)]
                for obj, src in zip(objects, sources())]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]  # waits for all
        lib = os.path.join(tmp, path.name)
        link = [nvcc(), '-shared', '-o', lib, *objects]
        failed = [f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n{log}'
                  for cmd, proc, log in zip(cmds, procs, logs)
                  if proc.returncode != 0]
        if failed:  # every source's errors, not the first one's only
            raise RuntimeError('\n'.join(failed))
        linked = subprocess.run(link, capture_output=True, text=True)
        if linked.returncode != 0:
            raise RuntimeError(f'nvcc failed ({linked.returncode}):\n'
                               f'{" ".join(link)}\n{linked.stdout}'
                               f'{linked.stderr}')
        path.with_suffix('.log').write_text(''.join(logs))
        os.replace(lib, path)  # atomic: a concurrent build never sees half
    return path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built library, loaded once per process, with every entry's
    ``argtypes`` and ``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fvt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fvt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor(name: str, t, shape: tuple, device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raises unless ``t`` is a contiguous, 16-byte aligned tensor of
    ``dtype`` and ``shape`` on ``device``: what every kernel here takes."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} is {t.dtype}, the kernel takes {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if t.data_ptr() % 16:
        raise ValueError(f'{name} must be 16-byte aligned')


def check(err: int, what: str) -> None:
    """Raises if a C entry returned a CUDA error."""
    if err != 0:
        msg = library().fvt_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
