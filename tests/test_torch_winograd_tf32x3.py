"""The split-TF32 (3xTF32) Winograd F(2x2, 3x3) conv of the port, on the
CPU.

The CUDA kernels (``csrc/winograd_tf32x3.cu``: input transform, one
batched ``wgmma`` product over the 16 transform-domain positions, output
transform) run only on the card; what they compute is held here: the
layout of V that the input transform writes, the layout of
:func:`pack_winograd_weights_tf32`, and
:func:`conv3x3_winograd_tf32x3_ref`, the emulation of the kernel's three
TF32 products, against ``fvt_tpu``'s ``conv3x3_winograd_pallas`` in
interpret mode and the direct ``conv3x3_pallas``, on numpy inputs from a
seed, at the shapes of ``tests/test_torch_winograd.py`` and at 5x5x512
(K = 512 a product).  Against the direct conv the tolerance is that of
the Winograd tests, rtol = atol = 2e-4 (the transforms reorder and
enlarge the partial sums; ``chip_smoke.py`` holds the kernel to it);
against JAX's Winograd, which sums the same transform-domain products,
1e-5: more than three times the largest difference measured on the CPU
at these shapes (2.9e-6, at 5x5x512; outputs up to 4.4 in magnitude).
Then the IR-50 on 2 frames with the emulation in place of the plain
Winograd, against ``fvt_tpu``'s embeddings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.arcface import VisualBackbone as FlaxVisualBackbone
from fvt_tpu.ops.conv_pallas import conv3x3_pallas
from fvt_tpu.ops.winograd import conv3x3_winograd_pallas
from fvt_tpu_torch.models.arcface import Conv3x3, VisualBackbone
from fvt_tpu_torch.models.from_jax import visual_backbone_state_from_flax
from fvt_tpu_torch.ops import conv as conv_ops
from fvt_tpu_torch.ops import winograd as winograd_ops
from test_torch_arcface_variants import ATOL as EMBED_ATOL
from test_torch_arcface_variants import RTOL as EMBED_RTOL
from test_torch_arcface_variants import _perturb
from test_torch_winograd import SHAPES as WINOGRAD_SHAPES

DIRECT_TOL = 2e-4
JAX_WINOGRAD_TOL = 1e-5
DEEP = (2, 5, 5, 512, 512)
SHAPES = WINOGRAD_SHAPES + [DEEP]


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
    k = (rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32)
    return x, k


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) & 0x1FFF


@pytest.mark.parametrize('shape', [(2, 5, 7, 8), (1, 1, 1, 4), (3, 4, 4, 12)])
def test_input_transform_is_bt_d_b_per_tile(shape):
    """``V[4a + b, p, c] = (B^T d B)[a, b]`` for the 4x4 patch d of tile p
    (frames, then tile rows, then tile columns), x zero outside the image:
    the layout the input-transform launch writes, against float64 matrix
    products tile by tile."""
    n, h, w, c = shape
    x = np.random.default_rng(sum(shape)).normal(size=shape)
    bt = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0],
                   [0, 1, 0, -1]], np.float64)
    th, tw = -(-h // 2), -(-w // 2)
    xp = np.zeros((n, 2 * th + 2, 2 * tw + 2, c))
    xp[:, 1:h + 1, 1:w + 1] = x
    want = np.empty((4, 4, n, th, tw, c))
    for f in range(n):
        for ty in range(th):
            for tx in range(tw):
                d = xp[f, 2 * ty:2 * ty + 4, 2 * tx:2 * tx + 4]
                want[:, :, f, ty, tx] = np.einsum('ai,ijc,bj->abc', bt, d, bt)
    got = winograd_ops.input_transform(torch.from_numpy(x).float())
    assert got.shape == (16, n * th * tw, c) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.reshape(16, -1, c),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('c,co', [(4, 4), (8, 4), (20, 36), (64, 64),
                                  (64, 200), (512, 128)])
def test_pack_winograd_weights_tf32_is_the_layout_the_kernel_copies(c, co):
    """``part[p, t, s, h, n8, n, k]`` is the split U of position ``p``,
    input channel ``8*s + 4*h + k`` and output channel ``bn*t + 8*n8 +
    n``, and 0 beyond C (C = 20: the last slice half empty) or Co (Co =
    36 and 200: a ragged column tile): per (position, column tile, slice)
    one contiguous block of K-major core matrices.  U of shape (4, 4, C,
    Co) packs as its (16, C, Co) view."""
    rng = np.random.default_rng(c + co)
    u = torch.from_numpy(rng.normal(size=(16, c, co)).astype(np.float32))
    bn = conv_ops.column_tile(co)
    tiles, slices = -(-co // bn), -(-c // 8)
    parts = winograd_ops.pack_winograd_weights_tf32(u)
    whole = torch.zeros(16, slices * 8, tiles * bn)
    whole[:, :c, :co] = u
    for part, want in zip(parts, conv_ops.split_tf32(whole)):
        assert part.shape == (16, tiles, slices, 2, bn // 8, 8, 4)
        assert part.dtype == torch.float32 and part.is_contiguous()
        p, t, s, h, n8, n, kk = np.meshgrid(
            *(np.arange(d) for d in part.shape), indexing='ij')
        np.testing.assert_array_equal(
            part.numpy(),
            want.numpy()[p, 8 * s + 4 * h + kk, bn * t + 8 * n8 + n])
    hi, lo = parts
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    for again, part in zip(winograd_ops.pack_winograd_weights_tf32(
            u.reshape(4, 4, c, co)), parts):
        assert torch.equal(again, part)


@pytest.mark.parametrize('shape', SHAPES)
def test_winograd_tf32x3_ref_matches_fvt_tpu(shape):
    """The kernel's three TF32 products, emulated, against fvt_tpu's
    Winograd Pallas kernel (interpret mode) within JAX_WINOGRAD_TOL and
    the direct Pallas conv within DIRECT_TOL; the plain Winograd within
    DIRECT_TOL of it."""
    x, k = _inputs(shape, 8)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    got = winograd_ops.conv3x3_winograd_tf32x3_ref(xt, kt)
    assert got.shape == x.shape[:3] + k.shape[3:]
    assert got.dtype == torch.float32 and got.is_contiguous()
    pallas = np.asarray(conv3x3_winograd_pallas(
        jnp.asarray(x), jnp.asarray(k), interpret=True))
    direct = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(k),
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=JAX_WINOGRAD_TOL,
                               atol=JAX_WINOGRAD_TOL)
    np.testing.assert_allclose(got.numpy(), direct, rtol=DIRECT_TOL,
                               atol=DIRECT_TOL)
    np.testing.assert_allclose(
        got.numpy(), winograd_ops.conv3x3_winograd_ref(xt, kt).numpy(),
        rtol=DIRECT_TOL, atol=DIRECT_TOL)
    # the transformed weights the caller may keep give the same bits
    u = winograd_ops.transform_weights(kt)
    assert torch.equal(
        winograd_ops.conv3x3_winograd_tf32x3_ref(xt, kt, u), got)


def test_one_tf32_product_is_coarser_than_the_split_at_k_512():
    """Why three products: the transform-domain product of V and U
    rounded to TF32 alone (hi * hi) is more than ten times further from
    the float32 Winograd than the split is, over K = 512."""
    x, k = (torch.from_numpy(a) for a in _inputs(DEEP, 9))
    want = winograd_ops.conv3x3_winograd_ref(x, k)
    v = winograd_ops.input_transform(x)
    u = winograd_ops.transform_weights(k).reshape(16, 512, 512)
    m = torch.bmm(conv_ops.split_tf32(v)[0], conv_ops.split_tf32(u)[0])
    plain_tf32 = winograd_ops.output_transform(m, *x.shape[:3])
    split = winograd_ops.conv3x3_winograd_tf32x3_ref(x, k)
    assert ((plain_tf32 - want).abs().max()
            > 10 * (split - want).abs().max())


def test_workspace_and_cpu_path():
    """The workspace is V (16, P, C) and M (16, P, Co); on the CPU
    neither Winograd kernel launches: both wrappers return the plain
    version's bits, any channel count."""
    x, k = (torch.from_numpy(a) for a in _inputs((3, 5, 7, 6, 10), 10))
    v, m = winograd_ops.workspace(x, 10)
    assert v.shape == (16, 3 * 3 * 4, 6) and m.shape == (16, 3 * 3 * 4, 10)
    want = winograd_ops.conv3x3_winograd_ref(x, k)
    for fn in (winograd_ops.conv3x3_winograd,
               winograd_ops.conv3x3_winograd_simt):
        assert torch.equal(fn(x, k), want)
    packed = winograd_ops.pack_winograd_weights_tf32(
        winograd_ops.transform_weights(k[..., :8]))
    assert torch.equal(
        winograd_ops.conv3x3_winograd(x, k[..., :8], packed=packed),
        winograd_ops.conv3x3_winograd_ref(x, k[..., :8]))
    assert winograd_ops.conv3x3_winograd.launches == 0
    assert winograd_ops.conv3x3_winograd_simt.launches == 0
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match='no backward'):
        winograd_ops.conv3x3_winograd_simt(x, k)


def test_winograd_kernel_module_keeps_the_packed_weights():
    """``Conv3x3(impl='winograd_kernel')`` packs the split U once, packs
    it again when ``weight`` is written, and packs nothing for a width
    the kernel does not take or for another path."""
    conv = Conv3x3(8, 12, impl='winograd_kernel')
    torch.nn.init.normal_(conv.weight)
    hwio, u, (hi, lo) = conv.kernel_weights()
    assert conv.kernel_weights()[2][0] is hi
    for part, want in zip((hi, lo),
                          winograd_ops.pack_winograd_weights_tf32(u)):
        assert torch.equal(part, want)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert torch.equal(conv.kernel_weights()[2][0], 2.0 * hi)
    assert Conv3x3(6, 12, impl='winograd_kernel').kernel_weights()[2] is None
    assert Conv3x3(8, 12, impl='winograd').kernel_weights()[2] is None


@pytest.fixture(scope='module')
def flax_backbone():
    rng = np.random.default_rng(0)
    variables = jax.jit(lambda r, x: FlaxVisualBackbone().init(
        r, x, train=False))(jax.random.key(1), jnp.zeros((1, 40, 40, 3)))
    variables = {'params': _perturb(variables['params'], rng, stats=False),
                 'batch_stats': _perturb(variables['batch_stats'], rng,
                                         stats=True)}
    crops = rng.uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    want = {impl: np.asarray(jax.jit(
        lambda v, x: FlaxVisualBackbone(conv_impl=impl).apply(
            v, x, train=False))(variables, jnp.asarray(crops)))
        for impl in ('xla', 'winograd_pallas')}
    state = visual_backbone_state_from_flax(variables['params'],
                                            variables['batch_stats'])
    return state, crops, want


def test_backbone_with_split_winograd_matches_fvt_tpu(flax_backbone,
                                                      monkeypatch):
    """The IR-50 on 2 frames through ``conv_impl='winograd'`` with the
    emulation of the kernel's products in place of the plain Winograd, in
    all 45 stride-1 convs, against fvt_tpu's embeddings (direct and
    Winograd Pallas) within ``test_torch_arcface_variants``' tolerance."""
    state, crops, want = flax_backbone
    calls = []

    def split(x, kernel, u=None):
        calls.append(x.shape)
        return winograd_ops.conv3x3_winograd_tf32x3_ref(x, kernel, u)

    monkeypatch.setattr(winograd_ops, 'conv3x3_winograd_ref', split)
    model = VisualBackbone(conv_impl='winograd').eval()
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(crops)).numpy()
    assert len(calls) == 45 and got.shape == (2, 512)
    for impl in ('xla', 'winograd_pallas'):
        np.testing.assert_allclose(got, want[impl], rtol=EMBED_RTOL,
                                   atol=EMBED_ATOL)
