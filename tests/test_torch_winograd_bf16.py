"""The bfloat16 route of the port's Winograd F(2x2, 3x3) conv (``--amp``),
on the CPU.

The CUDA kernels (``csrc/winograd_bf16.cu``: the input transform, then one
bfloat16 ``wgmma`` product with the output transform in its epilogue) run
only on the card; what they compute is held here, on numpy inputs from a
seed: V of :func:`input_transform` on bfloat16 against V built from
``fvt_tpu``'s own ``_bt_pairs`` on ``jnp.bfloat16`` slices, bit for bit;
U against ``fvt_tpu``'s ``transform_weights``; the layout of
:func:`pack_winograd_weights_bf16`; and :func:`conv3x3_winograd_bf16_ref`
against ``fvt_tpu``'s ``conv3x3_winograd`` (XLA) and
``conv3x3_winograd_pallas`` (interpret mode) on bfloat16 arrays at the
stage shapes of ``tests/test_winograd.py``.

The gate there is one bfloat16 unit in the last place of the JAX result,
plus 2^-16 absolute: both sides sum the same exact products of bfloat16
values in float32, in another order, and round once, so y flips by one
unit where the float32 sum straddles a rounding boundary; only a result
that cancels to near zero (|y| ~ 1e-5 at outputs ~ 0.8, a few in 10^5 at
these shapes) differs by more units than one, by the float32 sums' own
error (at most 4e-6 measured), which the absolute term covers.  A bfloat16
``bmm`` (M rounded to bfloat16) misses that gate by thousands of units.
Then the IR-50 on 2 frames with ``dtype=torch.bfloat16`` on both Winograd
paths against ``fvt_tpu``'s ``VisualBackbone(dtype=jnp.bfloat16,
conv_impl='winograd' | 'winograd_pallas')``, under the gate of
``test_torch_arcface_bf16.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.arcface import VisualBackbone as FlaxVisualBackbone
from fvt_tpu.ops import winograd as jax_winograd
from fvt_tpu_torch.models.arcface import Conv3x3, VisualBackbone
from fvt_tpu_torch.ops import winograd as winograd_ops
from test_torch_arcface_bf16 import arcface  # noqa: F401 (a fixture)
from test_winograd import STAGE_SHAPES

BF16 = torch.bfloat16
FLOOR = 2.0 ** -16
# fvt_tpu's XLA Winograd, jitted: the same bits as op by op on bfloat16
_xla_winograd = jax.jit(jax_winograd.conv3x3_winograd)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, and torch's spinning threads made this file's runs tens of
    times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5).astype(
        np.float32)
    return x, k


def _bf16(a) -> np.ndarray:
    """A bfloat16 array or tensor as float32 numpy (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place of each value (8 bits)."""
    mag = np.abs(a)
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.where(mag > 0, 2.0 ** (exp - 7), 0.0)


def _apart(got: np.ndarray, want: np.ndarray) -> float:
    """max of |got - want| over the gate, one unit of want plus FLOOR."""
    return float((np.abs(got - want) / (_ulp(want) + FLOOR)).max())


@pytest.mark.parametrize('shape', [(2, 5, 7, 16), (1, 1, 1, 16),
                                   (3, 4, 4, 32), (2, 10, 10, 64)])
def test_input_transform_in_bf16_is_fvt_tpus_bit_for_bit(shape):
    """V = B^T d B on bfloat16: every add and subtract rounded, over the
    rows first, then the columns, as ``fvt_tpu``'s ``conv3x3_winograd``
    builds it from ``_bt_pairs`` on ``jnp.bfloat16`` slices: the same
    bits (the transform is not exact in bfloat16: float32 differs)."""
    n, h, w, c = shape
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    xp, th, tw = jax_winograd._pad_for_tiles(
        jnp.asarray(x).astype(jnp.bfloat16))
    d = [[xp[:, a:a + 2 * th - 1:2, b:b + 2 * tw - 1:2, :]
          for b in range(4)] for a in range(4)]
    rows = [jax_winograd._bt_pairs(d[0][b], d[1][b], d[2][b], d[3][b])
            for b in range(4)]
    v = [jax_winograd._bt_pairs(rows[0][a], rows[1][a], rows[2][a],
                                rows[3][a]) for a in range(4)]
    want = np.stack([_bf16(v[a][b]) for a in range(4) for b in range(4)])
    got = winograd_ops.input_transform(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16 and got.is_contiguous()
    assert got.shape == (16, n * th * tw, c)
    np.testing.assert_array_equal(_bf16(got), want.reshape(16, -1, c))
    if c == 64:  # enough values that some add rounds
        exact = winograd_ops.input_transform(torch.from_numpy(x).to(BF16)
                                             .float())
        assert not torch.equal(exact, got.float())


@pytest.mark.parametrize('shape', [(2, 5, 7, 32), (2, 4, 4, 16)])
def test_v_chunks_is_the_layout_the_kernel_keeps(shape):
    """The bfloat16 kernel keeps V 8 channels a chunk: ``out[pos, j, p,
    k] = V[pos, p, 8*j + k]``, (16, C/8, P8, 8) with P8 = P rounded up to
    8 (P = 24 and 8 here, then 27), rows beyond P zero, so that a chunk's
    rows are contiguous; the plain V in that layout is what the chip check
    holds the first launch to."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=shape).astype(np.float32)).to(BF16)
    v = winograd_ops.input_transform(x)
    p, c = v.shape[1:]
    got = winograd_ops.v_chunks(v)
    assert got.shape == (16, c // 8, p + -p % 8, 8) and got.is_contiguous()
    pos, j, r, k = np.meshgrid(*(np.arange(d) for d in got.shape[:2]),
                               np.arange(p), np.arange(8), indexing='ij')
    np.testing.assert_array_equal(_bf16(got)[:, :, :p],
                                  _bf16(v)[pos, r, 8 * j + k])
    assert not got[:, :, p:].any()
    # a P that is no multiple of 8: 3 * 3 * 3 = 27 rows padded to 32
    v = winograd_ops.input_transform(x[:, :, :5].repeat(2, 1, 1, 1)[:3])
    got = winograd_ops.v_chunks(v)
    assert got.shape[2] == -(-v.shape[1] // 8) * 8
    assert torch.equal(got[:, :, :v.shape[1]].transpose(1, 2).reshape(
        v.shape), v) and not got[:, :, v.shape[1]:].any()


@pytest.mark.parametrize('c,co', [(16, 8), (64, 64), (128, 256)])
def test_bf16_u_is_fvt_tpus(c, co):
    """U of the bfloat16 route is ``G g G^T`` in float32 from the
    bfloat16 kernel, rounded to bfloat16 once:
    ``transform_weights(kernel.astype(bf16)).astype(bf16)``."""
    _, k = _inputs((1, 1, 1, c, co), c + co)
    want = _bf16(jax_winograd.transform_weights(
        jnp.asarray(k).astype(jnp.bfloat16)).astype(jnp.bfloat16))
    got = winograd_ops.transform_weights_bf16(torch.from_numpy(k))
    assert got.dtype == BF16 and got.shape == (16, c, co)
    np.testing.assert_array_equal(_bf16(got), want.reshape(16, c, co))
    # the same from the kernel already in bfloat16
    again = winograd_ops.transform_weights_bf16(torch.from_numpy(k).to(BF16))
    assert torch.equal(again, got)


@pytest.mark.parametrize('shape', STAGE_SHAPES)
def test_winograd_bf16_ref_matches_fvt_tpu(shape):
    """The plain bfloat16 version against ``fvt_tpu``'s XLA Winograd and
    its Pallas kernel in interpret mode, on the same bfloat16 arrays,
    within one unit in the last place (plus FLOOR)."""
    x, k = _inputs(shape, 11)
    xb, kb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, k))
    xla = _bf16(_xla_winograd(xb, kb))
    pallas = _bf16(jax_winograd.conv3x3_winograd_pallas(xb, kb,
                                                        interpret=True))
    xt, kt = torch.from_numpy(x).to(BF16), torch.from_numpy(k).to(BF16)
    y = winograd_ops.conv3x3_winograd_bf16_ref(xt, kt)
    assert y.dtype == BF16 and y.is_contiguous()
    assert y.shape == x.shape[:3] + k.shape[3:]
    got = _bf16(y)
    for name, want in (('XLA', xla), ('Pallas', pallas)):
        assert _apart(got, want) <= 1.0, (name, _apart(got, want))
    # the weights the caller may keep give the same bits, in either shape
    u = winograd_ops.transform_weights_bf16(kt)
    for kept in (u, u.reshape(4, 4, *k.shape[2:])):
        assert torch.equal(
            winograd_ops.conv3x3_winograd_bf16_ref(xt, kt, kept), y)


@pytest.mark.parametrize('shape', [(4, 10, 10, 128, 128), (4, 5, 5, 512, 512)])
def test_a_bf16_product_would_miss_the_gate(shape):
    """Why the plain version multiplies V and U as float32: a bfloat16
    ``bmm`` rounds M to bfloat16 before the output transform, and lands
    hundreds of units from ``fvt_tpu``'s result, where the float32 product
    lands within one."""
    x, k = _inputs(shape, 12)
    n, h, w = shape[:3]
    want = _bf16(_xla_winograd(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, k))))
    xt, kt = torch.from_numpy(x).to(BF16), torch.from_numpy(k).to(BF16)
    v = winograd_ops.input_transform(xt)
    m = torch.bmm(v, winograd_ops.transform_weights_bf16(kt))
    assert m.dtype == BF16
    rounded = _bf16(winograd_ops.output_transform(m, n, h, w).to(BF16))
    assert _apart(rounded, want) > 100
    assert _apart(_bf16(winograd_ops.conv3x3_winograd_bf16_ref(xt, kt)),
                  want) <= 1.0


@pytest.mark.parametrize('c,co', [(16, 8), (32, 64), (64, 200),
                                  (512, 128)])
def test_pack_winograd_weights_bf16_is_the_layout_the_kernel_copies(c, co):
    """``packed[p, t, s, h, n8, k, n]`` is U of position ``p``, input
    channel ``16*s + 8*h + k`` and output channel ``64*t + 8*n8 + n``, and
    0 beyond Co (Co = 8 and 200: a ragged column tile): per (position,
    column tile, slice) one contiguous block of the N-major 8x8 blocks
    ``wgmma`` reads.  U of shape (4, 4, C, Co) packs as its (16, C, Co)
    view; C not a multiple of 16 raises."""
    rng = np.random.default_rng(c + co)
    u = torch.from_numpy(rng.normal(size=(16, c, co)).astype(np.float32)
                         ).to(BF16)
    bn = winograd_ops.BF16_BN
    tiles = -(-co // bn)
    packed = winograd_ops.pack_winograd_weights_bf16(u)
    assert packed.shape == (16, tiles, c // 16, 2, bn // 8, 8, 8)
    assert packed.dtype == BF16 and packed.is_contiguous()
    whole = torch.zeros(16, c, tiles * bn, dtype=BF16)
    whole[:, :, :co] = u
    p, t, s, h, n8, k, n = np.meshgrid(
        *(np.arange(d) for d in packed.shape), indexing='ij')
    np.testing.assert_array_equal(
        _bf16(packed),
        _bf16(whole)[p, 16 * s + 8 * h + k, bn * t + 8 * n8 + n])
    assert torch.equal(
        winograd_ops.pack_winograd_weights_bf16(u.reshape(4, 4, c, co)),
        packed)
    with pytest.raises(ValueError, match='multiples of 16'):
        winograd_ops.pack_winograd_weights_bf16(u[:, :8])


def test_bf16_cpu_path_runs_the_plain_version():
    """On the CPU ``conv3x3_winograd`` on bfloat16 tensors returns the
    plain bfloat16 version's bits, with the weights derived or kept, any
    width, and counts no launch; mixed types raise."""
    x, k = (torch.from_numpy(a).to(BF16)
            for a in _inputs((3, 5, 7, 24, 12), 13))
    want = winograd_ops.conv3x3_winograd_bf16_ref(x, k)
    assert torch.equal(winograd_ops.conv3x3_winograd(x, k), want)
    u = winograd_ops.transform_weights_bf16(k)
    assert torch.equal(winograd_ops.conv3x3_winograd(x, k, u), want)
    # V 8 channels a chunk, its 36 rows padded to 40
    assert winograd_ops.workspace_bf16(x).shape == (16, 3, 40, 8)
    assert winograd_ops.workspace_bf16(x).dtype == BF16
    assert (winograd_ops.conv3x3_winograd.launches,
            winograd_ops.conv3x3_winograd.launches_bf16,
            winograd_ops.conv3x3_winograd.launches_fp32) == (0, 0, 0)
    with pytest.raises(ValueError, match='one of'):
        winograd_ops.conv3x3_winograd(x, k.float())
    with pytest.raises(ValueError, match='one of'):
        winograd_ops.conv3x3_winograd_simt(x, k)


@pytest.mark.parametrize('c,co,ok', [(16, 8, True), (512, 512, True),
                                     (24, 8, False), (16, 12, False),
                                     (20, 40, False)])
def test_bf16_widths_the_kernel_takes(c, co, ok):
    """The shape check a CUDA tensor goes through: bfloat16 C a multiple
    of 16 and Co of 8 (every ArcFace conv qualifies), float32 multiples
    of 4."""
    if ok:
        winograd_ops.check_widths('conv3x3_winograd', BF16, c, co)
    else:
        with pytest.raises(ValueError, match='multiples of 16'):
            winograd_ops.check_widths('conv3x3_winograd', BF16, c, co)
    winograd_ops.check_widths('conv3x3_winograd', torch.float32, 20, 12)
    with pytest.raises(ValueError, match='multiples of 4'):
        winograd_ops.check_widths('conv3x3_winograd', torch.float32, 6, 8)


def test_bf16_winograd_module_keeps_u_from_the_bf16_kernel():
    """``Conv3x3(impl='winograd_kernel', dtype=bfloat16)`` derives U from
    its bfloat16 HWIO kernel (the one ``cast_weights`` keeps), packs it
    once for the bfloat16 kernel, derives both again when ``weight`` is
    written in place or replaced, and packs nothing for a width the
    kernel does not take or on the plain path."""
    conv = Conv3x3(16, 24, impl='winograd_kernel', dtype=BF16)
    torch.nn.init.normal_(conv.weight, std=0.3)
    hwio, u, packed = conv.kernel_weights()
    assert hwio is conv.cast_weights()[1] and hwio.dtype == BF16
    assert torch.equal(u, winograd_ops.transform_weights_bf16(
        conv.weight.detach().permute(2, 3, 1, 0)))
    # from the bfloat16 kernel: not U of the float32 weight, rounded
    assert not torch.equal(u, winograd_ops.transform_weights(
        conv.weight.detach().permute(2, 3, 1, 0)).reshape(16, 16, 24)
        .to(BF16))
    assert torch.equal(packed, winograd_ops.pack_winograd_weights_bf16(u))
    assert conv.kernel_weights()[2] is packed
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert torch.equal(conv.kernel_weights()[1], 2 * u)
    conv.weight = torch.nn.Parameter(conv.weight * 0.25)
    assert torch.equal(conv.kernel_weights()[1], u / 2)
    assert Conv3x3(8, 24, impl='winograd_kernel',
                   dtype=BF16).kernel_weights()[2] is None
    assert Conv3x3(16, 24, impl='winograd',
                   dtype=BF16).kernel_weights()[2] is None


@pytest.fixture(scope='module')
def flax_winograd_bf16(arcface):  # noqa: F811 (the imported fixture)
    """``fvt_tpu``'s ``VisualBackbone(dtype=jnp.bfloat16)`` through its
    XLA Winograd and its Pallas Winograd kernel (interpret mode)."""
    variables = {'params': arcface['params'],
                 'batch_stats': arcface['stats']}
    return {impl: np.asarray(jax.jit(
        lambda v, x: FlaxVisualBackbone(
            dtype=jnp.bfloat16, conv_impl=impl).apply(v, x, train=False))(
        variables, jnp.asarray(arcface['crops'])))
        for impl in ('winograd', 'winograd_pallas')}


@pytest.mark.parametrize('conv_impl', ['winograd', 'winograd_kernel'])
def test_bf16_winograd_backbone_matches_flax_bf16(arcface,  # noqa: F811
                                                  flax_winograd_bf16,
                                                  conv_impl):
    """The port's bfloat16 IR-50 on a Winograd path (the plain bfloat16
    version in all 45 stride-1 convs on the CPU) against ``fvt_tpu``'s
    bfloat16 Winograd backbones within twice JAX's own bfloat16 distance
    from float32, as ``test_torch_arcface_bf16.py`` holds the other
    paths; the fused blocks beside it against the same within that gate."""
    model = VisualBackbone(conv_impl=conv_impl, dtype=BF16).eval()
    model.load_state_dict(arcface['state'], strict=True)
    x = torch.from_numpy(arcface['crops'])
    with torch.inference_mode():
        got = model(x)
        plain = model(x, reference=True)
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    got = got.numpy()
    for impl, want in flax_winograd_bf16.items():
        own = np.abs(want - arcface['fp32']).max()
        apart = np.abs(got - want).max()
        assert 0 < own and apart <= 2 * own, (impl, apart, own)
    assert np.abs(got - arcface['fp32']).max() > 1e-4  # it is bfloat16
    assert winograd_ops.conv3x3_winograd.launches == 0
    fused = VisualBackbone(conv_impl=conv_impl, dtype=BF16,
                           fused_blocks=True).eval()
    fused.load_state_dict(arcface['state'], strict=True)
    with torch.inference_mode():
        got = fused(x).numpy()
    own = np.abs(arcface['functional'] - arcface['fp32']).max()
    want = flax_winograd_bf16['winograd']
    assert np.abs(got - want).max() <= 2 * own
