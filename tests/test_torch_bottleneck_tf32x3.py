"""The split-TF32 fused BottleneckIR block (B5) of the port, on the CPU.

The CUDA kernel (``fvt_bottleneck_tf32x3_forward`` in
``csrc/conv3x3_tf32x3.cu``: two launches of the split-TF32 ``wgmma`` conv,
bn1 applied where conv1 splits x, PReLU in conv1's store, bn2 and the
residual in conv2's) runs only on the card; what it computes is held here:
:func:`bn1_line`, conv1's input as the kernel stages it, against explicit
zero padding, bit for bit, with a bn1 shift of 20 so that a pad which took
b1 shows; :func:`bottleneck_ir_fused_tf32x3_ref`, the emulation of the
kernel's three TF32 products a multiply in both convs, against
``fvt_tpu``'s ``bottleneck_ir_fused`` in interpret mode and the flax block
on the same numpy weights, within the float32 gate the card holds the
kernel to (rtol = atol = 1e-4, ``chip_smoke.py``; the largest difference
measured here is 3.3e-6, at 5x5x512 on 2 frames, where a sum runs over K
= 9 * 512 = 4608 products twice, on outputs up to 5.3); the CPU path of
the wrappers; the packed split weights that ``BottleneckIR`` keeps; and
the IR-50 on 2 frames with the emulation in all 21 identity blocks
against ``fvt_tpu``'s ``arcface_forward_eval(fused_blocks=True)`` within
the tolerance of ``test_torch_arcface_variants``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fvt_tpu.ops import bottleneck_pallas as jax_ops
from fvt_tpu_torch.models.arcface import BottleneckIR, arcface_forward_eval
from fvt_tpu_torch.models.from_jax import fused_block_args_from_flax
from fvt_tpu_torch.ops import bottleneck as bottleneck_ops
from fvt_tpu_torch.ops import conv as conv_ops
from test_torch_arcface_variants import ATOL as EMBED_ATOL
from test_torch_arcface_variants import RTOL as EMBED_RTOL
from test_torch_arcface_variants import _port, arcface  # noqa: F401
from test_torch_bottleneck import _block, _flax_eval

GATE = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, and torch's spinning threads made this file's runs tens of
    times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('hw,c,n', [(12, 64, 6), (8, 128, 4), (5, 128, 3),
                                    (1, 8, 2), (5, 512, 2)])
def test_tf32x3_ref_meets_the_fp32_gate(hw, c, n):
    """The emulation of the kernel against fvt_tpu's fused Pallas block
    (interpret mode), the flax block and the plain version, on weights
    from ``fused_block_args_from_flax``, within rtol = atol = 1e-4."""
    block, params, stats, x = _block(n, hw, c, seed=0)
    args = fused_block_args_from_flax(params, stats)
    xt = torch.from_numpy(x)
    got = bottleneck_ops.bottleneck_ir_fused_tf32x3_ref(xt, *args)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert got.is_contiguous()
    pallas = np.asarray(jax_ops.bottleneck_ir_fused(
        jnp.asarray(x), params, stats, batch_tile=2, interpret=True))
    for want in (pallas, _flax_eval(block, params, stats, x),
                 bottleneck_ops.bottleneck_ir_fused_ref(xt, *args).numpy()):
        np.testing.assert_allclose(got.numpy(), want, rtol=GATE, atol=GATE)


def _explicit_line(x, a1, b1):
    """The padded line by explicit zero padding: a pad row above and a pad
    column left of every frame's image, channels to whole slices of 8."""
    c = x.shape[3]
    t = F.pad(x * a1 + b1, (0, -(-c // 8) * 8 - c, 1, 0, 1, 0))
    return t.reshape(-1, t.shape[3])


@pytest.mark.parametrize('n,h,w,c', [
    (3, 7, 9, 32),    # odd extents, ragged last row tile
    (2, 6, 5, 20),    # C = 20: a slice's second chunk lies beyond C
    (3, 10, 10, 16),  # Q = 363: the line ends inside the second row tile
    (7, 5, 5, 16),    # one row tile stages all 7 frames and runs past Q
    (1, 1, 1, 4)])    # one pixel, one chunk
def test_bn1_line_is_explicit_padding(n, h, w, c):
    """conv1's staged input, computed by the kernel's own test of a
    coordinate (q < Q, row and column on the line not 0, channel below C),
    equals explicit zero padding bit for bit, and is 0 from Q on to the
    last coordinate the last row tile stages.  bn1's shift is 20, so a pad
    that took b1 would be 20 off."""
    rng = np.random.default_rng(n * 100 + c)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    a1 = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b1 = torch.from_numpy((rng.normal(size=c) * 20).astype(np.float32))
    line = bottleneck_ops.bn1_line(x, a1, b1)
    q_all = n * (h + 1) * (w + 1)
    p = -(-(bottleneck_ops.ROW_TILE + 2 * (w + 1) + 2)
          // bottleneck_ops.LOAD) * bottleneck_ops.LOAD
    tiles = -(-(q_all - (w + 2)) // bottleneck_ops.ROW_TILE)
    assert line.shape == ((tiles - 1) * bottleneck_ops.ROW_TILE + p,
                          -(-c // 8) * 8)
    assert line.shape[0] > q_all  # the last tile stages past the last frame
    want = _explicit_line(x, a1, b1)
    assert torch.equal(line[:q_all], want)
    assert not line[q_all:].any()
    assert (want == 0).sum() == (line == 0).sum() - line[q_all:].numel()
    assert b1.abs().max() > 10  # the trap is real here


def test_tf32x3_ref_keeps_conv1_pad_zero_not_b1():
    """With bn1's shift at 20 the emulation still matches the flax block:
    a version that padded before the affine is off by ~|b1| * sum|w| at
    the border (``test_torch_bottleneck.test_conv1_pad_is_zero_not_b1``).
    Within the gate, rtol = atol = 1e-4, on outputs up to 37."""
    block, params, stats, x = _block(2, 6, 20, seed=4, b1_scale=20.0)
    args = fused_block_args_from_flax(params, stats)
    got = bottleneck_ops.bottleneck_ir_fused_tf32x3_ref(
        torch.from_numpy(x), *args)
    want = _flax_eval(block, params, stats, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=GATE, atol=GATE)


def test_wrappers_on_cpu_take_the_plain_version_and_refuse_grad():
    """On the CPU neither fused kernel launches: both wrappers return the
    plain version's bits, with or without packed weights and at any C;
    both refuse gradients and a device with no kernel."""
    block, params, stats, x = _block(3, 5, 12, seed=6)
    args = fused_block_args_from_flax(params, stats)
    xt = torch.from_numpy(x)
    want = bottleneck_ops.bottleneck_ir_fused_ref(xt, *args)
    packed = bottleneck_ops.pack_block_weights(*args[:2])
    for got in (bottleneck_ops.bottleneck_ir_fused(xt, *args),
                bottleneck_ops.bottleneck_ir_fused(xt, *args, packed=packed),
                bottleneck_ops.bottleneck_ir_fused_simt(xt, *args)):
        assert torch.equal(got, want)
    w = torch.zeros(3, 3, 6, 6)
    v = torch.ones(6)
    six = bottleneck_ops.bottleneck_ir_fused(torch.ones(1, 2, 2, 6), w, w,
                                             v, v, v, v, v)
    assert torch.equal(six, torch.ones(1, 2, 2, 6) + 1)
    for fn in (bottleneck_ops.bottleneck_ir_fused,
               bottleneck_ops.bottleneck_ir_fused_simt):
        grad = xt.clone().requires_grad_()
        with pytest.raises(RuntimeError, match='no backward'):
            fn(grad, *args)
        with pytest.raises(ValueError, match='no kernel'):
            fn(xt.to('meta'), *(t.to('meta') for t in args))
    assert bottleneck_ops.bottleneck_ir_fused.launches == 0
    assert bottleneck_ops.bottleneck_ir_fused_simt.launches == 0


@pytest.mark.parametrize('c', [20, 256])
def test_pack_block_weights_is_pack_weights_tf32_twice(c):
    """Both kernels split and packed at column tiles of 64 whatever C: the
    block's launches take no other (the plain conv takes 128 at C = 256);
    ``part[t, s, tap, h, n8, n, k]`` is the split weight of input channel
    ``8*s + 4*h + k`` and output channel ``64*t + 8*n8 + n``."""
    rng = np.random.default_rng(8)
    w1, w2 = (torch.from_numpy(rng.normal(size=(3, 3, c, c))
                               .astype(np.float32)) for _ in range(2))
    packed = bottleneck_ops.pack_block_weights(w1, w2)
    assert bottleneck_ops.BLOCK_BN == 64
    tiles, slices = -(-c // 64), -(-c // 8)
    for pair, w in zip(packed, (w1, w2)):
        whole = torch.zeros(9, slices * 8, tiles * 64)
        whole[:, :c, :c] = w.reshape(9, c, c)
        for part, want in zip(pair, conv_ops.split_tf32(whole)):
            assert part.shape == (tiles, slices, 9, 2, 8, 8, 4)
            assert part.is_contiguous()
            t, s, tap, h, n8, n, k = np.meshgrid(
                *(np.arange(d) for d in part.shape), indexing='ij')
            np.testing.assert_array_equal(
                part.numpy(),
                want.numpy()[tap, 8 * s + 4 * h + k, 64 * t + 8 * n8 + n])


def test_block_module_keeps_the_packed_split_weights():
    """``BottleneckIR.fused_weights`` keeps both convs' packed split
    weights beside the rest, hands the same tensors again, and derives
    them again after an in-place write; a width the kernel does not take
    has none."""
    blk = BottleneckIR(16, 16, 1).eval()
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for conv in (blk.res_layer[1], blk.res_layer[3]):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
    kept = blk.fused_weights()
    w1, w2, packed = kept[0], kept[1], kept[-1]
    assert len(kept) == 8 and blk.fused_weights()[-1] is packed
    for pair, want in zip(packed, bottleneck_ops.pack_block_weights(w1, w2)):
        for part, want_part in zip(pair, want):
            assert torch.equal(part, want_part)
    with torch.no_grad():
        blk.res_layer[3].weight.mul_(2.0)
    again = blk.fused_weights()[-1]
    assert again is not packed
    assert torch.equal(again[0][0], packed[0][0])
    for part, was in zip(again[1], packed[1]):  # 2x scales the split exactly
        assert torch.equal(part, 2.0 * was)
    assert BottleneckIR(6, 6, 1).fused_weights()[-1] is None


def test_backbone_with_split_blocks_matches_fvt_tpu(arcface,  # noqa: F811
                                                    monkeypatch):
    """The IR-50 on 2 frames with ``fused_blocks=True`` and the emulation
    of the kernel in place of the plain block, in all 21 identity blocks,
    against fvt_tpu's ``arcface_forward_eval(fused_blocks=True)`` (the
    Pallas block in interpret mode) and its direct path."""
    calls = []

    def split(x, *args):
        calls.append(x.shape)
        return bottleneck_ops.bottleneck_ir_fused_tf32x3_ref(x, *args)

    monkeypatch.setattr(bottleneck_ops, 'bottleneck_ir_fused_ref', split)
    model = _port(arcface)
    got = arcface_forward_eval(model, torch.from_numpy(arcface['crops']),
                               fused_blocks=True).numpy()
    assert len(calls) == 21 and got.shape == (2, 512)
    for want in (arcface['fused_blocks'], arcface['direct']):
        np.testing.assert_allclose(got, want, rtol=EMBED_RTOL,
                                   atol=EMBED_ATOL)
