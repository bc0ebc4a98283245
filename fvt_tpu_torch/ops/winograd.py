"""Winograd F(2x2, 3x3) convolution: CUDA kernel and plain version.

Counterpart of ``fvt_tpu/ops/winograd.py``.  A 3x3 stride-1 'same'
convolution computed per 2x2 output tile as ``Y = A^T [(G g G^T) *
(B^T d B)] A``: 16 transform-domain products per tile, input channel and
output channel where the direct convolution takes 36.  The transform
matrices hold only 0, +-1 (B, A) and +-1/2 (G), so the transforms are
exact in float32 and the result differs from the direct convolution only
in the order of the sums.  Layouts follow the JAX package: activations
NHWC, kernel HWIO ``(3, 3, C, Co)``, output ``(N, H, W, Co)``; odd H or W
are padded to whole tiles and cropped.

:func:`conv3x3_winograd_ref` is the plain version (the port of the
XLA-ops ``conv3x3_winograd``: the transform-domain tensors are
materialised).  :func:`conv3x3_winograd` runs it for a tensor on the CPU;
for a CUDA tensor it launches the kernel of ``csrc/winograd.cu``, which
keeps the transform-domain tensors on chip, or raises.
``conv3x3_winograd.launches`` counts kernel launches.  Eval only.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops.conv import refuse_grad


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, Co) -> transform-domain (4, 4, C, Co): U = G g G^T
    with G = [[1, 0, 0], [1/2, 1/2, 1/2], [1/2, -1/2, 1/2], [0, 0, 1]]
    applied over each of the two tap axes."""
    def g_rows(w):  # contract the leading 3-tap axis with G -> 4
        return torch.stack([w[0], 0.5 * (w[0] + w[1] + w[2]),
                            0.5 * (w[0] - w[1] + w[2]), w[2]])

    u = g_rows(kernel.float())                     # (4, 3, C, Co)
    u = g_rows(u.transpose(0, 1))                  # (4, 4, C, Co), (col, row)
    return u.transpose(0, 1).contiguous()          # back to (row, col)


def _bt(x0, x1, x2, x3):
    """B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] along one tap
    axis, given the four tap slices."""
    return x0 - x2, x1 + x2, x2 - x1, x1 - x3


def _at(m0, m1, m2, m3):
    """A^T = [[1,1,1,0],[0,1,-1,-1]] along one tap axis."""
    return m0 + m1 + m2, m1 - m2 - m3


def conv3x3_winograd_ref(x: torch.Tensor, kernel: torch.Tensor,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version.  ``u`` is ``transform_weights(kernel)`` if
    the caller has it already."""
    n, h, w, c = x.shape
    co = kernel.shape[3]
    th, tw = -(-h // 2), -(-w // 2)
    # 'same' pad, then right/bottom pad so that the extent is 2*tiles + 2
    xp = F.pad(x, (0, 0, 1, 1 + 2 * tw - w, 1, 1 + 2 * th - h))
    if u is None:
        u = transform_weights(kernel)
    u = u.reshape(4, 4, c, co)

    # d[a][b](ty, tx) = xp[:, 2*ty + a, 2*tx + b, :]
    d = [[xp[:, a:a + 2 * th - 1:2, b:b + 2 * tw - 1:2, :]
          for b in range(4)] for a in range(4)]
    # V = B^T d B, tap axis by tap axis
    rows = [_bt(d[0][b], d[1][b], d[2][b], d[3][b]) for b in range(4)]
    v = [_bt(rows[0][a], rows[1][a], rows[2][a], rows[3][a])
         for a in range(4)]
    p = n * th * tw
    m = [[v[a][b].reshape(p, c) @ u[a, b] for b in range(4)]
         for a in range(4)]
    # Y = A^T m A
    ya = [_at(m[0][b], m[1][b], m[2][b], m[3][b]) for b in range(4)]
    out = [_at(ya[0][i], ya[1][i], ya[2][i], ya[3][i]) for i in range(2)]
    y = torch.stack([torch.stack(out[0]), torch.stack(out[1])])
    y = y.reshape(2, 2, n, th, tw, co).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(n, 2 * th, 2 * tw, co)[:, :h, :w, :].contiguous()


def conv3x3_winograd(x: torch.Tensor, kernel: torch.Tensor,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, C) float32, kernel HWIO (3, 3, C, Co).  Returns
    (N, H, W, Co).  ``u``: ``transform_weights(kernel)``, (4, 4, C, Co) or
    (16, C, Co), when the caller keeps it (it is computed outside the
    kernel, once per weight); computed here otherwise."""
    refuse_grad('conv3x3_winograd', x, kernel)
    if x.device.type == 'cpu':
        return conv3x3_winograd_ref(x, kernel, u)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if c % 4 or co % 4:
        raise ValueError(f'C {c}, Co {co}: the kernel takes multiples of 4')
    if u is None:
        build.check_tensor('kernel', kernel, (3, 3, c, co), x.device)
        u = transform_weights(kernel)
    u = u.reshape(16, c, co)
    build.check_tensor('x', x, (n, h, w, c), x.device)
    build.check_tensor('u', u, (16, c, co), x.device)
    out = torch.empty((n, h, w, co), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = build.library().fvt_winograd_forward(
        x.data_ptr(), u.data_ptr(), out.data_ptr(), n, h, w, c, co,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'winograd kernel (N={n}, H={h}, W={w}, C={c}, '
                     f'Co={co})')
    conv3x3_winograd.launches += 1
    return out


conv3x3_winograd.launches = 0
