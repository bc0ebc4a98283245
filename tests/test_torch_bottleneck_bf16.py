"""The fused BottleneckIR block (B5) on bfloat16 tensors (``--amp``), on
the CPU.

The CUDA route (``fvt_bottleneck_bf16_wgmma_forward`` in
``csrc/bottleneck_bf16_wgmma.cu``: two launches of the block's own
bfloat16 ``wgmma`` kernel, bn1 over conv1's staged slices, PReLU in
conv1's store, bn2 and the residual in conv2's; its addressing is
emulated in ``tests/test_torch_bottleneck_bf16_wgmma.py``) runs only on
the card; what it computes is held
here: :func:`bottleneck_ir_fused_bf16_ref`, the Pallas kernel's rounding
points, against ``fvt_tpu``'s ``bottleneck_ir_fused`` on bfloat16 arrays
in interpret mode (as ``tests/test_bottleneck_pallas.py`` runs it); the
CPU path of the wrapper; and the packed weights ``BottleneckIR`` keeps.

The tolerance is the one ``chip_smoke.py`` holds the card's bfloat16
kernels to, what bfloat16's rounding accounts for: both sides sum exact
products in float32 in another order, so conv1's sums differ in their
last float32 bits and v, rounded to bfloat16 once, flips by one unit in
the last place (2^-8 relative) where a sum straddles a rounding boundary;
conv2 carries each flip to y weighted by one of its 9*C products, and y,
rounded once, then flips by one unit too: ``|got - want| <= 2^-7 |want|
+ 2^-9`` elementwise, and such flips are rare, so the mean difference
stays below 1e-4 of the mean magnitude (a wrong tap or a pad that took b1
breaks that by orders of magnitude).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.ops import bottleneck_pallas as jax_ops
from fvt_tpu_torch.models.arcface import BottleneckIR
from fvt_tpu_torch.models.from_jax import fused_block_args_from_flax
from fvt_tpu_torch.ops import bottleneck as bottleneck_ops
from fvt_tpu_torch.ops import conv as conv_ops
from test_torch_bottleneck import _block

BF16 = torch.bfloat16
RTOL, ATOL, MEAN_TOL = 2.0 ** -7, 2.0 ** -9, 1e-4


def _bf16_args(params, stats):
    """The port's block arguments with both kernels in bfloat16 (the
    Pallas block casts them to x's type) and the vectors float32."""
    w1, w2, *vecs = fused_block_args_from_flax(params, stats)
    return (w1.to(BF16), w2.to(BF16), *vecs)


def _pallas_bf16(x, params, stats):
    return np.asarray(jax_ops.bottleneck_ir_fused(
        jnp.asarray(x).astype(jnp.bfloat16), params, stats, batch_tile=2,
        interpret=True), dtype=np.float32)


def _assert_bf16_close(got, want):
    err = np.abs(got - want)
    assert (err <= RTOL * np.abs(want) + ATOL).all(), err.max()
    assert err.mean() <= MEAN_TOL * np.abs(want).mean(), err.mean()


@pytest.mark.parametrize('hw,c,n,b1_scale', [(10, 64, 4, 0.1),
                                             (5, 512, 2, 0.1),
                                             (10, 64, 3, 20.0)])
def test_bf16_ref_matches_pallas_bf16(hw, c, n, b1_scale):
    """The plain version against the Pallas block on the same bfloat16
    inputs, within the bfloat16 gate (the module docstring); the last case
    has bn1's shift at 20, where a pad that took b1 would be off by ~|b1|
    times a kernel's sum at every border pixel."""
    block, params, stats, x = _block(n, hw, c, seed=hw + c,
                                     b1_scale=b1_scale)
    args = _bf16_args(params, stats)
    xt = torch.from_numpy(x).to(BF16)
    got = bottleneck_ops.bottleneck_ir_fused_bf16_ref(xt, *args)
    assert got.dtype == BF16 and got.shape == xt.shape
    want = _pallas_bf16(x, params, stats)
    _assert_bf16_close(got.float().numpy(), want)
    if b1_scale > 1:
        # the trap is real: padding after bn1 moves the border pixels
        a1, b1 = args[2], args[3]
        t = (xt.float() * a1 + b1).to(BF16)
        pad_b1 = torch.nn.functional.pad(t.float(), (0, 0, 1, 1, 1, 1),
                                         value=0.0)
        pad_b1[:, 0], pad_b1[:, -1] = b1.to(BF16).float(), \
            b1.to(BF16).float()
        u_wrong = torch.nn.functional.conv2d(
            pad_b1.permute(0, 3, 1, 2), args[0].float().permute(3, 2, 0, 1))
        u_right = conv_ops.conv3x3_ref(t.float(), args[0].float())
        assert (u_wrong.permute(0, 2, 3, 1) - u_right).abs().max() > 1.0


def test_bf16_ref_rounds_u_after_prelu_not_before():
    """The Pallas kernel's contract, not its no-tile fallback's: conv1's
    float32 sums go through PReLU unrounded and v is rounded once.  A
    version that rounds u first (the fallback, ``bottleneck_pallas.py:
    198-209``) double-rounds the negative side: on these inputs it differs
    from the plain version in v, which the plain version, like Pallas,
    does not."""
    block, params, stats, x = _block(3, 10, 64, seed=5)
    w1, w2, a1, b1, alpha, a2, b2 = _bf16_args(params, stats)
    xt = torch.from_numpy(x).to(BF16)
    t = (xt.float() * a1 + b1).to(BF16).float()
    u = conv_ops.conv3x3_ref(t, w1.float())
    once = torch.where(u > 0, u, alpha * u).to(BF16)
    ub = u.to(BF16).float()
    twice = torch.where(ub > 0, ub, alpha * ub).to(BF16)
    assert (once != twice).any()
    got = bottleneck_ops.bottleneck_ir_fused_bf16_ref(
        xt, w1, w2, a1, b1, alpha, a2, b2)
    want = ((conv_ops.conv3x3_ref(once.float(), w2.float()) * a2 + b2)
            + xt.float()).to(BF16)
    assert torch.equal(got, want)


def test_bf16_wrapper_on_cpu_takes_the_plain_version():
    """On the CPU the wrapper runs the bfloat16 plain version for a
    bfloat16 tensor, with or without packed weights and at a C the card
    does not take (20); it launches nothing."""
    for c in (32, 20):
        block, params, stats, x = _block(2, 6, c, seed=c)
        args = _bf16_args(params, stats)
        xt = torch.from_numpy(x).to(BF16)
        want = bottleneck_ops.bottleneck_ir_fused_bf16_ref(xt, *args)
        got = bottleneck_ops.bottleneck_ir_fused(xt, *args)
        assert got.dtype == BF16 and torch.equal(got, want)
        if c % 16 == 0:
            packed = bottleneck_ops.pack_block_weights_bf16(*args[:2])
            assert torch.equal(bottleneck_ops.bottleneck_ir_fused(
                xt, *args, packed=packed), want)
    assert bottleneck_ops.bottleneck_ir_fused.launches == 0
    assert bottleneck_ops.bottleneck_ir_fused.launches_bf16 == 0


def test_bf16_wrapper_refuses_a_device_without_kernel_and_grad():
    block, params, stats, x = _block(1, 4, 16, seed=2)
    args = _bf16_args(params, stats)
    xt = torch.from_numpy(x).to(BF16)
    with pytest.raises(ValueError, match='no kernel'):
        bottleneck_ops.bottleneck_ir_fused(xt.to('meta'),
                                           *(t.to('meta') for t in args))
    with pytest.raises(RuntimeError, match='no backward'):
        bottleneck_ops.bottleneck_ir_fused(xt.clone().requires_grad_(),
                                           *args)


def test_bf16_block_module_keeps_the_convs_packing():
    """A bfloat16 ``BottleneckIR`` hands the fused block its kernels in
    bfloat16 and, packed, the very tensors its two ``Conv3x3`` keep for
    their own launches (``ops.conv.pack_weights``), the vectors float32;
    an in-place write derives them again."""
    blk = BottleneckIR(64, 64, 1, 'shifted_kernel', BF16).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for conv in (blk.res_layer[1], blk.res_layer[3]):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
    w1, w2, a1, b1, alpha, a2, b2, packed = blk.fused_weights()
    assert w1.dtype == w2.dtype == BF16 and w1.shape == (3, 3, 64, 64)
    assert all(v.dtype == torch.float32 for v in (a1, b1, alpha, a2, b2))
    conv1, conv2 = blk.res_layer[1], blk.res_layer[3]
    assert packed[0] is conv1.cast_weights()[2]
    assert packed[1] is conv2.cast_weights()[2]
    for got, want in zip(packed,
                         bottleneck_ops.pack_block_weights_bf16(w1, w2)):
        assert torch.equal(got, want)
    with torch.no_grad():
        conv2.weight.mul_(2.0)
    again = blk.fused_weights()
    assert again[-1][1] is not packed[1]
    assert torch.equal(again[1], conv2.weight.detach().permute(
        2, 3, 1, 0).to(BF16))
    assert torch.equal(again[1], 2.0 * w2)  # doubling is exact in bfloat16
    x = torch.randn(2, 64, 5, 5, generator=gen).to(BF16)
    with torch.inference_mode():
        y = blk(x, fused=True)
        plain = blk(x, fused=True, reference=True)
    assert y.dtype == BF16 and torch.equal(y, plain)
    assert BottleneckIR(20, 20, 1, 'cudnn', BF16).fused_weights()[-1] is None
