"""Fused eval-mode TCN temporal block: CUDA kernel and plain version.

Counterpart of ``fvt_tpu/ops/tcn_pallas.py`` (``fused_temporal_block``,
``tcn_forward_pallas``).  One block computes

    y = leaky(leaky(conv2(leaky(conv1(x)))) + res)

with causal dilated convs (left pad ``(K-1)*dilation``), leaky slope 0.01
and ``res`` the 1x1 downsample of ``x`` (or ``x`` itself).  Layouts follow
the JAX package: ``x (B, T, Cin)``, ``w1 (K, Cin, Cout)``,
``w2 (K, Cout, Cout)``, ``wd (Cin, Cout)``.

:func:`fused_temporal_block` runs :func:`fused_temporal_block_ref` for a
tensor on the CPU; for a CUDA tensor it launches the kernel of
``csrc/tcn_block.cu`` or raises.  ``fused_temporal_block.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build

NEG_SLOPE = 0.01


def fused_temporal_block_ref(x: torch.Tensor, w1: torch.Tensor,
                             b1: torch.Tensor, w2: torch.Tensor,
                             b2: torch.Tensor,
                             wd: Optional[torch.Tensor] = None,
                             bd: Optional[torch.Tensor] = None, *,
                             kernel_size: int, dilation: int) -> torch.Tensor:
    """Plain PyTorch version of the fused block (same math, same layouts)."""
    pad = (kernel_size - 1) * dilation

    def conv(v, w, b):  # v (B, T, C), w (K, C, Co) -> (B, T, Co)
        v = F.pad(v.transpose(1, 2), (pad, 0))
        y = F.conv1d(v, w.permute(2, 1, 0), b, dilation=dilation)
        return y.transpose(1, 2)

    h = F.leaky_relu(conv(x, w1, b1), NEG_SLOPE)
    net = F.leaky_relu(conv(h, w2, b2), NEG_SLOPE)
    res = x if wd is None else x @ wd + bd
    return F.leaky_relu(net + res, NEG_SLOPE)


def fused_temporal_block(x: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor,
                         wd: Optional[torch.Tensor] = None,
                         bd: Optional[torch.Tensor] = None, *,
                         kernel_size: int, dilation: int) -> torch.Tensor:
    """x (B, T, Cin); w1 (K, Cin, Cout); w2 (K, Cout, Cout); optional
    1x1 downsample wd (Cin, Cout), bd (Cout).  Returns (B, T, Cout)."""
    if x.device.type == 'cpu':
        return fused_temporal_block_ref(x, w1, b1, w2, b2, wd, bd,
                                        kernel_size=kernel_size,
                                        dilation=dilation)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    b, t, cin = x.shape
    cout = w1.shape[-1]
    if (wd is None) != (bd is None):
        raise ValueError('wd and bd are given together or not at all')
    if wd is None and cin != cout:
        raise ValueError(f'Cin {cin} != Cout {cout} needs a downsample')
    if cout % 4 or cout > 256 or 256 % cout:
        raise ValueError(f'Cout {cout}: the kernel takes a power of two '
                         f'from 4 to 256')
    checks = [('x', x, (b, t, cin)), ('w1', w1, (kernel_size, cin, cout)),
              ('b1', b1, (cout,)), ('w2', w2, (kernel_size, cout, cout)),
              ('b2', b2, (cout,))]
    if wd is not None:
        checks += [('wd', wd, (cin, cout)), ('bd', bd, (cout,))]
    for name, arr, shape in checks:
        build.check_tensor(name, arr, shape, x.device)
    out = torch.empty((b, t, cout), device=x.device, dtype=torch.float32)
    if b == 0 or t == 0:
        return out
    lib = build.library()
    err = lib.fvt_tcn_block_forward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), None if wd is None else wd.data_ptr(),
        None if bd is None else bd.data_ptr(), out.data_ptr(),
        b, t, cin, cout, kernel_size, dilation,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'tcn_block kernel (B={b}, T={t}, Cin={cin}, '
                     f'Cout={cout}, K={kernel_size}, dilation={dilation})')
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0


def tcn_forward(x: torch.Tensor, blocks: Sequence[dict], kernel_size: int,
                *, reference: bool = False) -> torch.Tensor:
    """A whole TemporalConvNet in eval mode, as ``tcn_forward_pallas``:
    block ``i`` has dilation ``2**i``.  ``blocks`` holds per block the
    materialised kernel weights ``w1, b1, w2, b2`` and ``wd, bd`` (None
    without a downsample).  ``reference=True`` runs the plain version."""
    fn = fused_temporal_block_ref if reference else fused_temporal_block
    for i, blk in enumerate(blocks):
        x = fn(x, blk['w1'], blk['b1'], blk['w2'], blk['b2'], blk['wd'],
               blk['bd'], kernel_size=kernel_size, dilation=2 ** i)
    return x
