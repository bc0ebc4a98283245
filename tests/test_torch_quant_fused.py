"""The int8 quantisation pass with its producer folded in
(``fvt_tpu_torch/ops/quant.py``: ``prologue_ref``, ``quantize_int8`` and
``quantize_int8_ref`` with a ``prologue``, ``reciprocal_rint``,
``fused_args``; ``csrc/quantize_int8_fused.cu`` runs on the card only)
against ``fvt_tpu`` on the CPU, and the backbone's route through it.

* The prologues against ``fvt_tpu``'s ``TorchEMABatchNorm(
  use_running_average=True, dtype=d)`` and ``PReLU`` on the same x and
  parameters: PReLU in float32 and bfloat16 and bn1 in bfloat16 bit for
  bit, eager and jitted.  bn1 in float32 is bit for bit given
  ``fvt_tpu``'s ``inv``; with the port's own ``inv`` (``bn_terms``) it is
  within 3 units of 2^-23 of ``|x - mean| * inv + |bias|`` (measured 2.05
  eager, 2.25 jitted): ``torch.rsqrt`` and XLA's rsqrt on the CPU round
  differently (measured: 17 and 12 of 64 channels off the correctly
  rounded value, ``inv`` one unit apart), and jitted XLA contracts the
  product and the sum into one fused multiply-add.
* ``quantize_int8_ref`` with a prologue against ``fvt_tpu``'s
  ``quantize_symmetric`` (dynamic) and ``clip(round(x / s))`` (static) of
  ``fvt_tpu``'s BatchNorm or PReLU output: q, scale and amax equal.
* The kernel's bfloat16 prologue steps (each a ``fma.rn.bf16x2``: the
  exact result rounded once, emulated in float64) bit for bit PyTorch's
  (float32, then rounded to bfloat16) over every exponent gap.
* The kernel's division by a reciprocal (``reciprocal_rint``, the rule
  emulated in float32 torch ops) against the true division after the
  clip to +-127: 10^6 values at scales from 1e-12/127 to 1e3, values built
  at (k + 1/2) * s and 1 to 4 units around them, exact half-integers at
  power-of-two scales, zeros, -0 and values far past the amax.
* ``fused_args``' refusals and the prologue cache's invalidation.
* The int8 backbone on the CPU: a quantised conv's input goes through no
  ``F.batch_norm`` or ``F.prelu`` (20 and 21 fewer calls than the float
  backbone's forward; train mode keeps every call); a block equals the
  composition of the prologue, ``conv3x3_int8`` and the rest.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu.models.layers import PReLU as JaxPReLU
from fvt_tpu.models.layers import TorchEMABatchNorm
from fvt_tpu.ops import quant as jax_quant
from fvt_tpu_torch.models import arcface
from fvt_tpu_torch.ops import quant

C = 64
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, c=C):
    """x (4, 6, 6, c) float32, a BatchNorm2d with drawn parameters and
    running statistics, its flax variables, PReLU slopes of both signs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 6, 6, c)) * 2).astype(np.float32)
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = rng.normal(0, 0.5, c).astype(np.float32)
    mu = rng.normal(0, 1, c).astype(np.float32)
    var = rng.uniform(0.2, 3, c).astype(np.float32)
    alpha = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    bn = nn.BatchNorm2d(c).requires_grad_(False)
    for t, a in ((bn.weight, w), (bn.bias, b), (bn.running_mean, mu),
                 (bn.running_var, var)):
        t.copy_(torch.from_numpy(a))
    variables = {'params': {'scale': jnp.asarray(w), 'bias': jnp.asarray(b)},
                 'batch_stats': {'mean': jnp.asarray(mu),
                                 'var': jnp.asarray(var)}}
    return x, bn, variables, alpha


def _jax_bn(x, variables, jd, jit):
    model = TorchEMABatchNorm(use_running_average=True, dtype=jd)
    fn = jax.jit(model.apply) if jit else model.apply
    return np.asarray(fn(variables, jnp.asarray(x).astype(jd))
                      .astype(jnp.float32))


def _jax_prelu(x, alpha, jd, jit):
    model = JaxPReLU(x.shape[-1])
    fn = jax.jit(model.apply) if jit else model.apply
    return np.asarray(fn({'params': {'alpha': jnp.asarray(alpha)}},
                         jnp.asarray(x).astype(jd)).astype(jnp.float32))


def _bn1(bn, td):
    return ('bn1', *arcface.bn_terms(bn, bn.running_mean, bn.running_var,
                                     td))


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'jit'])
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_prelu_prologue_is_fvt_tpus(dtype, jit):
    jd, td = DTYPES[dtype]
    x, _, _, alpha = _setup(1)
    x[0, 0, 0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    got = quant.prologue_ref(torch.from_numpy(x).to(td),
                             ('prelu', torch.from_numpy(alpha).to(td)))
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  _jax_prelu(x, alpha, jd, jit))


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'jit'])
def test_bn1_prologue_bfloat16_is_fvt_tpus(jit):
    x, bn, variables, _ = _setup(2)
    got = quant.prologue_ref(torch.from_numpy(x).bfloat16(),
                             _bn1(bn, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _jax_bn(x, variables, jnp.bfloat16, jit))


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'jit'])
def test_bn1_prologue_float32(jit):
    """Given ``fvt_tpu``'s inv, eager XLA computes the same three steps:
    bit for bit.  With the port's inv (and, jitted, XLA's fused
    multiply-add) within 3 units of 2^-23 of the terms' magnitude."""
    x, bn, variables, _ = _setup(3)
    want = _jax_bn(x, variables, jnp.float32, jit)
    mean, inv, bias = arcface.bn_terms(bn, bn.running_mean, bn.running_var,
                                       torch.float32)
    inv_jax = np.asarray(jax.lax.rsqrt(variables['batch_stats']['var']
                                       + jnp.float32(bn.eps))
                         * variables['params']['scale'])
    assert np.abs(inv.numpy() - inv_jax).max() <= np.spacing(
        np.abs(inv_jax)).max()
    given = quant.prologue_ref(torch.from_numpy(x), (
        'bn1', mean, torch.from_numpy(inv_jax.copy()), bias)).numpy()
    if not jit:
        np.testing.assert_array_equal(given, want)
    got = quant.prologue_ref(torch.from_numpy(x), ('bn1', mean, inv,
                                                   bias)).numpy()
    terms = (np.abs((x - mean.numpy()) * inv.numpy())
             + np.abs(bias.numpy()))
    assert (np.abs(got - want) <= 3 * 2.0 ** -23 * terms).all()


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
@pytest.mark.parametrize('kind', ['bn1', 'prelu'])
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_quantize_ref_with_prologue_is_fvt_tpus(dtype, kind, static):
    """q, scale and amax of the port's plain pass equal ``fvt_tpu``'s
    quantisation of its BatchNorm or PReLU output (float32 bn1 given
    ``fvt_tpu``'s inv, as the test above says why)."""
    jd, td = DTYPES[dtype]
    x, bn, variables, alpha = _setup(4)
    x[0, 0, 0, 0] = 9.0  # a post-PReLU tail
    if kind == 'prelu':
        v = _jax_prelu(x, alpha, jd, False)
        prologue = ('prelu', torch.from_numpy(alpha).to(td))
    else:
        v = _jax_bn(x, variables, jd, False)
        prologue = _bn1(bn, td)
        if dtype == 'float32':
            prologue = prologue[:2] + (torch.from_numpy(np.array(
                jax.lax.rsqrt(variables['batch_stats']['var']
                              + jnp.float32(bn.eps))
                * variables['params']['scale'])),) + prologue[3:]
    vj = jnp.asarray(v)
    xt = torch.from_numpy(x).to(td)
    if static:
        amax = np.float32(np.abs(v).max() * 0.8)  # values clip at 127
        scale = quant.act_scale(torch.tensor([amax]))
        want_q = np.asarray(jnp.clip(jnp.round(vj / jnp.asarray(
            scale.numpy())), -127, 127).astype(jnp.int8))
        q, s, a = quant.quantize_int8_ref(xt, scale, prologue)
        assert a is None and (np.abs(want_q) == 127).any()
    else:
        want_q, want_s = jax_quant.quantize_symmetric(vj)
        q, s, a = quant.quantize_int8_ref(xt, None, prologue)
        np.testing.assert_array_equal(s.reshape(()).numpy(),
                                      np.asarray(want_s).reshape(()))
        assert a.item() == np.abs(v).max()
        # the wrapper routes a CPU tensor to the plain version
        q2, s2, a2 = quant.quantize_int8(xt, None, prologue)
        assert torch.equal(q2, q) and torch.equal(s2, s) \
            and torch.equal(a2, a)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))


def _round_once(exact: np.ndarray) -> torch.Tensor:
    """float64 values rounded once, half to even, to bfloat16 (8
    significant bits; normal range): what ``fma.rn.bf16x2`` gives."""
    m, e = np.frexp(exact)
    return torch.from_numpy(np.ldexp(np.rint(m * 256), e - 8)).bfloat16()


def _wide_bf16(rng, shape, spread):
    """bfloat16 values of both signs over 2 * spread binades."""
    return torch.from_numpy((rng.uniform(-1, 1, shape)
                             * np.exp2(rng.integers(-spread, spread, shape)))
                            .astype(np.float32)).bfloat16()


@pytest.mark.parametrize('spread', [2, 12, 40])
def test_bf16x2_steps_are_pytorchs(spread):
    """The kernel's bfloat16 prologue runs each step as one
    ``fma.rn.bf16x2``: the exact result rounded once.  PyTorch computes a
    bfloat16 op in float32 and rounds again; 24 >= 2 * 8 + 2 bits, so the
    two agree bit for bit (here on 4 x 64 channels of wide-ranging values,
    differences of every exponent gap)."""
    rng = np.random.default_rng(8 + spread)
    x = _wide_bf16(rng, (4096, 64), spread)
    mean, inv, bias, alpha = (_wide_bf16(rng, (64,), spread)
                              for _ in range(4))
    f64 = [t.double().numpy() for t in (x, mean, inv, bias, alpha)]
    d = _round_once(f64[0] - f64[1])
    p = _round_once(d.double().numpy() * f64[2])
    want = _round_once(p.double().numpy() + f64[3])
    got = quant.prologue_ref(x, ('bn1', mean, inv, bias))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # PReLU by the sign bit: -0 takes -0 * alpha, equal as a value
    x[0, :2] = torch.tensor([0.0, -0.0])
    prod = _round_once(x.double().numpy() * f64[4])
    want = torch.where(torch.signbit(x), prod, x)
    got = quant.prologue_ref(x, ('prelu', alpha))
    assert torch.equal(got, want)


def _clipped(t):
    return torch.clamp(t, -127, 127)


def test_reciprocal_rule_equals_the_division_on_a_million_values():
    rng = np.random.default_rng(5)
    scales = np.geomspace(1e-12 / 127, 1e3, 100).astype(np.float32)
    u = rng.uniform(-140, 140, (100, 10 ** 4)).astype(np.float32)
    s = torch.from_numpy(scales)[:, None]
    v = torch.from_numpy(u) * s  # t spans the whole range and past 127
    got, exact = quant.reciprocal_rint(v, s)
    want = torch.round(v / s)
    assert torch.equal(_clipped(got), _clipped(want))
    # the exact division is the exception: 2 * 2^-12 of the values below
    # 128 in magnitude, about 4.5e-4 of these
    share = exact.float().mean().item()
    assert 1e-4 < share < 1e-3


@pytest.mark.parametrize('scale', [1e-12 / 127, 3.7e-9, 0.0123, 1.0, 0.25,
                                   2.0 ** -20, 977.0])
def test_reciprocal_rule_at_half_integers(scale):
    """Values built at (k + 1/2) * s, and 1 to 4 float32 units either
    side, k from -130 to 129; at power-of-two scales (k + 1/2) * s is
    exact, so v / s is the half-integer itself (ties to even)."""
    s = np.float32(scale)
    k = np.arange(-130, 130, dtype=np.float32)
    base = ((k + np.float32(0.5)) * s).astype(np.float32)
    vals = [base]
    up, down = base.copy(), base.copy()
    for _ in range(4):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        vals += [up.copy(), down.copy()]
    # zeros, -0 and values far past a calibrated amax of 127 * s
    vals.append(np.array([0.0, -0.0, 1e3 * s, -1e3 * s, 1e6 * s,
                          np.float32(3e38)], np.float32))
    v = torch.from_numpy(np.concatenate(vals))
    st = torch.tensor(s)
    got, exact = quant.reciprocal_rint(v, st)
    want = torch.round(v / st)
    assert torch.equal(_clipped(got), _clipped(want))
    # every value built at a half-integer takes the exact division
    assert exact[:base.size][np.abs(k) < 127].all()
    # and q is the quantisation's
    assert torch.equal(_clipped(got).to(torch.int8),
                       quant.quantize_with(v, st))


def test_reciprocal_rule_without_a_normal_reciprocal():
    """A scale whose reciprocal is subnormal or infinite takes the exact
    division everywhere."""
    v = torch.linspace(-1e38, 1e38, 1001)
    for s in (torch.tensor(3e38), torch.tensor(1e-45)):
        got, exact = quant.reciprocal_rint(v, s)
        assert exact.all()
        assert torch.equal(got, torch.round(v / s))


def test_fused_args_and_refusals():
    x = torch.zeros(2, 3, 3, 32)
    ones = torch.ones(32)
    assert quant.fused_args(x, None)[:2] == (16, 0)
    c, code, p0, p1, p2 = quant.fused_args(x, ('bn1', ones, ones, ones))
    assert (c, code) == (32, 1) and None not in (p0, p1, p2)
    assert quant.fused_args(x, ('prelu', ones))[:2] == (32, 2)
    assert quant.fused_args(x, ('prelu', ones))[3:] == (None, None)
    bad = [
        (torch.zeros(2, 3, 3, 24), ('prelu', torch.ones(24)), 'multiples'),
        (torch.zeros(1, 1, 1, quant.MAX_C + 16),
         ('prelu', torch.ones(quant.MAX_C + 16)), 'multiples'),
        (x, ('prelu', torch.ones(16)), 'shape'),
        (x, ('prelu', torch.ones(32, dtype=torch.bfloat16)), 'bfloat16'),
        (x, ('prelu', torch.ones(32, device='meta')), 'meta'),
        (x, ('bn1', ones, ones), 'takes'),
        (x, ('relu', ones), 'relu'),
        (x.permute(0, 3, 1, 2), ('prelu', torch.ones(3)), 'contiguous'),
        (torch.zeros(3, 5), None, 'multiples of 16'),
    ]
    for xx, prologue, says in bad:
        with pytest.raises(ValueError, match=says):
            quant.fused_args(xx, prologue)
    with pytest.raises(ValueError, match='relu'):
        quant.prologue_ref(x, ('relu', ones))
    conv = arcface.Conv3x3(64, 64, impl='int8')
    with pytest.raises(ValueError, match='not quantised'):
        conv(torch.zeros(1, 64, 5, 5), prologue=('prelu', torch.ones(64)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_prologue_cache(dtype):
    blk = arcface.BottleneckIR(128, 128, 1, 'int8', dtype)
    blk.requires_grad_(False)
    p1, p2 = blk.int8_prologues()
    assert p1[0] == 'bn1' and p2[0] == 'prelu'
    assert all(t.dtype == dtype and t.shape == (128,) for t in p1[1:] + p2[1:])
    assert blk.int8_prologues() == (p1, p2)  # the same tensors, kept
    bn1, _, prelu, _, bn2 = blk.res_layer
    bn2.running_var.mul_(2.0)  # not bn1: kept
    assert blk.int8_prologues()[0] is p1
    for write in (lambda: bn1.running_var.mul_(2.0),
                  lambda: bn1.running_mean.add_(1.0),
                  lambda: bn1.weight.mul_(3.0),
                  lambda: bn1.bias.add_(1.0),
                  lambda: prelu.weight.mul_(-1.0),
                  lambda: setattr(prelu.weight, 'data',
                                  torch.full((128,), 0.5))):
        before = blk.int8_prologues()
        write()
        after = blk.int8_prologues()
        assert after is not before
        assert torch.equal(after[0][2], arcface.bn_terms(
            bn1, bn1.running_mean, bn1.running_var, dtype)[1])
        assert torch.equal(after[1][1], prelu.weight.to(dtype))


def _count_calls(fn) -> dict:
    """The calls of ``F.batch_norm`` and ``F.prelu`` while ``fn()`` runs."""
    n = {'batch_norm': 0, 'prelu': 0}
    with pytest.MonkeyPatch.context() as mp:
        for name in n:
            real = getattr(F, name)

            def counted(*a, _real=real, _name=name, **kw):
                n[_name] += 1
                return _real(*a, **kw)

            mp.setattr(F, name, counted)
        fn()
    return n


@pytest.fixture(scope='module')
def backbones():
    g = torch.Generator().manual_seed(6)
    fp = arcface.VisualBackbone()
    fp.reset_parameters(g)
    q = arcface.VisualBackbone(conv_impl='int8')
    q.load_state_dict(fp.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 40, 40, 3)).astype(np.float32))
    return fp, q, x


def test_quantised_convs_call_no_batch_norm_or_prelu(backbones):
    fp, q, x = backbones
    with torch.inference_mode():
        counts = {name: _count_calls(lambda: model(x, **kw))
                  for name, model, kw in (
                      ('float', fp, {}), ('int8', q, {}),
                      ('int8 plain', q, {'reference': True}))}
    # the stem, 24 blocks' bn1 and bn2, 3 shortcuts, the head's two
    assert counts['float'] == {'batch_norm': 54, 'prelu': 25}
    for name in ('int8', 'int8 plain'):
        assert counts[name] == {'batch_norm': 54 - 20, 'prelu': 25 - 21}
    # train mode keeps today's order: every PReLU runs as an op of its own
    n = _count_calls(lambda: q(x, train=True,
                               generator=torch.Generator().manual_seed(0)))
    assert n['prelu'] == 25


def test_block_is_the_composition(backbones):
    """body8 (256 -> 256): conv1 quantises bn1's output and conv2 PReLU's,
    each through ``conv3x3_int8`` of the prologue's output, then bn2 and
    the shortcut as before."""
    _, q, _ = backbones
    blk = q.backbone.body[8]
    bn1, conv1, prelu, conv2, bn2 = blk.res_layer
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 10, 10, 256))
                         .astype(np.float32)).permute(0, 3, 1, 2)
    p1, p2 = blk.int8_prologues()
    with torch.inference_mode():
        got = blk(x)
        nhwc = x.permute(0, 2, 3, 1)
        h = quant.conv3x3_int8(quant.prologue_ref(nhwc, p1),
                               conv1.weight.permute(2, 3, 1, 0), 1,
                               torch.float32)
        r = quant.conv3x3_int8(quant.prologue_ref(h, p2),
                               conv2.weight.permute(2, 3, 1, 0), 1,
                               torch.float32)
        want = arcface.batchnorm_eval(bn2, r.permute(0, 3, 1, 2)) + x
    assert torch.equal(got, want)
