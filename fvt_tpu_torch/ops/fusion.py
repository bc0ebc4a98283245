"""Fused eval-mode LFAN multimodal fusion: CUDA kernel and plain version.

Counterpart of ``fvt_tpu/ops/fusion_pallas.py::fused_multimodal_fusion``:
per frame, a packed qkv projection per modality (head-major, ``[q|k|v]``
inside each head), softmax attention over the M modality slots per head,
the +V residual, ``o_proj`` and a LayerNorm (eps 1e-5, no residual).
Layouts follow the JAX package: ``x[m] (B, T, C_m)``,
``wqkv[m] (C_m, 3E)``, ``wo (E*M, E*M)``; the output is ``(B, T, E*M)``,
head-major then modality.

:func:`fused_multimodal_fusion` runs :func:`fused_multimodal_fusion_ref`
for tensors on the CPU; for CUDA tensors it launches the kernel of
``csrc/fusion.cu`` or raises, on the route :func:`fusion_route` picks:
every weight in shared memory where the layout fits (the main path's
three modalities), else Wo, or Wo and Wqkv, read from global memory.
``fused_multimodal_fusion.launches`` counts kernel launches.  The kernel
is eval-only; training runs :func:`multimodal_attention_ref` under
autograd.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build

LN_EPS = 1e-5
# the seven LFAN modalities with embedding sizes (kMaxModal)
MAX_MODALITIES = 7
# the kernel's frames a tile and shared memory (csrc/fusion.cu)
TILE_FRAMES = 8
MAX_SMEM = 227 * 1024
# a route's weight matrices read from global memory, a bit each; the
# kernel's three routes, in the order tried
WQKV_GLOBAL, WO_GLOBAL = 1, 2
ROUTES = (0, WO_GLOBAL, WQKV_GLOBAL | WO_GLOBAL)


def smem_bytes(widths: Sequence[int], modal_dim: int, route: int) -> int:
    """Shared memory of the kernel's layout (``Smem`` in
    ``csrc/fusion.cu``) for modality widths ``widths`` on ``route``: the
    weight matrices not read from global memory, the biases and the
    LayerNorm's vectors, and a tile's x, qkv, attention output and
    o_proj output."""
    ctot, m = sum(widths), len(widths)
    e3, em = 3 * modal_dim, modal_dim * m
    floats = ((0 if route & WQKV_GLOBAL else ctot * e3) + m * e3
              + (0 if route & WO_GLOBAL else em * em) + 3 * em
              + TILE_FRAMES * (ctot + m * e3 + 2 * em))
    return 4 * floats


@functools.lru_cache(maxsize=None)
def fusion_route(widths: Tuple[int, ...], modal_dim: int) -> int:
    """The first of :data:`ROUTES` whose layout fits shared memory: 0 (all
    weights staged, the main path's) where it can, then Wo read from
    global memory, then both Wo and Wqkv.  Raises where none fits."""
    for route in ROUTES:
        if smem_bytes(widths, modal_dim, route) <= MAX_SMEM:
            return route
    raise ValueError(f'widths {list(widths)}, modal_dim {modal_dim}: a '
                     f'tile\'s activations alone leave the kernel\'s shared '
                     f'memory')


def multimodal_attention_ref(xs: Sequence[torch.Tensor],
                             wqkv: Sequence[torch.Tensor],
                             bqkv: Sequence[torch.Tensor],
                             wo: torch.Tensor, bo: torch.Tensor, *,
                             modal_dim: int, num_heads: int) -> torch.Tensor:
    """The attention over the modality slots up to ``o_proj``, before the
    LayerNorm: plain, differentiable PyTorch (the train path puts its
    dropout between the two, ``fvt_tpu/models/fusion.py:84-90``)."""
    b, t, _ = xs[0].shape
    m = len(xs)
    hd = modal_dim // num_heads
    # (B, T, M, H, 3hd) -> q, k, v each (B, T, H, M, hd)
    qkv = torch.stack([x @ w + bias for x, w, bias in zip(xs, wqkv, bqkv)],
                      dim=2).reshape(b, t, m, num_heads, 3 * hd)
    q, k, v = qkv.transpose(2, 3).split(hd, dim=-1)
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    values = (attn @ v + v).reshape(b, t, modal_dim * m)
    return values @ wo + bo


def fused_multimodal_fusion_ref(xs: Sequence[torch.Tensor],
                                wqkv: Sequence[torch.Tensor],
                                bqkv: Sequence[torch.Tensor],
                                wo: torch.Tensor, bo: torch.Tensor,
                                ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                                *, modal_dim: int,
                                num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the fusion block (same math, layouts)."""
    o = multimodal_attention_ref(xs, wqkv, bqkv, wo, bo,
                                 modal_dim=modal_dim, num_heads=num_heads)
    return F.layer_norm(o, (o.shape[-1],), ln_scale, ln_bias, LN_EPS)


def fused_multimodal_fusion(xs: Sequence[torch.Tensor],
                            wqkv: Sequence[torch.Tensor],
                            bqkv: Sequence[torch.Tensor],
                            wo: torch.Tensor, bo: torch.Tensor,
                            ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                            *, modal_dim: int,
                            num_heads: int) -> torch.Tensor:
    """xs: M tensors (B, T, C_m) in modality order; wqkv[m] (C_m, 3E),
    bqkv[m] (3E); wo (E*M, E*M); bo, ln_scale, ln_bias (E*M).  Returns
    (B, T, E*M).  Eval only: the kernel has no backward, as the Pallas
    kernel has none, so inputs that require grad are refused while grad
    mode is on."""
    x0 = xs[0]
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (*xs, *wqkv, *bqkv, wo, bo, ln_scale,
                                      ln_bias)):
        raise RuntimeError('fused_multimodal_fusion has no backward: call '
                           'it under torch.no_grad(), or take the train '
                           'path of MultimodalTransformerEncoder')
    if x0.device.type == 'cpu':
        return fused_multimodal_fusion_ref(
            xs, wqkv, bqkv, wo, bo, ln_scale, ln_bias, modal_dim=modal_dim,
            num_heads=num_heads)
    if x0.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x0.device}')
    m = len(xs)
    if not 1 <= m <= MAX_MODALITIES:
        raise ValueError(f'{m} modalities: the kernel takes 1 to '
                         f'{MAX_MODALITIES}')
    if len(wqkv) != m or len(bqkv) != m:
        raise ValueError('one qkv weight and bias per modality')
    if modal_dim % num_heads or modal_dim % 4:
        raise ValueError(f'modal_dim {modal_dim}: the kernel takes a '
                         f'multiple of 4 and of num_heads {num_heads}')
    if any(x.shape[-1] % 4 for x in xs):
        raise ValueError(f'widths {[x.shape[-1] for x in xs]}: the kernel '
                         f'takes multiples of 4')
    b, t, _ = x0.shape
    em = modal_dim * m
    checks = [('wo', wo, (em, em)), ('bo', bo, (em,)),
              ('ln_scale', ln_scale, (em,)), ('ln_bias', ln_bias, (em,))]
    for i, (x, w, bias) in enumerate(zip(xs, wqkv, bqkv)):
        c = x.shape[-1]
        checks += [(f'xs[{i}]', x, (b, t, c)),
                   (f'wqkv[{i}]', w, (c, 3 * modal_dim)),
                   (f'bqkv[{i}]', bias, (3 * modal_dim,))]
    for name, arr, shape in checks:
        build.check_tensor(name, arr, shape, x0.device)
    out = torch.empty((b, t, em), device=x0.device, dtype=torch.float32)
    if b * t == 0:
        return out
    widths = tuple(x.shape[-1] for x in xs)
    route = fusion_route(widths, modal_dim)
    ptrs = (ctypes.c_void_p * (3 * m))(
        *(a.data_ptr() for ts in (xs, wqkv, bqkv) for a in ts))
    err = build.library().fvt_fusion_forward(
        ptrs, _widths(widths), wo.data_ptr(), bo.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), b * t, m,
        modal_dim, num_heads, route,
        torch.cuda.current_stream(x0.device).cuda_stream)
    if err:  # the message is built only for an error
        build.check(err, f'fusion kernel (N={b * t}, M={m}, E={modal_dim}, '
                         f'H={num_heads}, C={widths}, route={route})')
    fused_multimodal_fusion.launches += 1
    return out


fused_multimodal_fusion.launches = 0


@functools.lru_cache(maxsize=None)
def _widths(widths: Tuple[int, ...]) -> ctypes.Array:
    """The widths as the C entry reads them (a host int array), made once
    a tuple: the wrapper's host time is on a dispatch's path."""
    return (ctypes.c_int * len(widths))(*widths)
