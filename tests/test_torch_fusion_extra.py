"""The port's ``models/fusion_extra.py`` and ``TemporalConvNet(attention=1)``
against ``fvt_tpu``'s, on the CPU.

The same numpy-seeded inputs go through ``fvt_tpu.models.fusion_extra``
and the port, on flax trees filled with numpy by leaf name and carried
over by ``from_jax.module_state_from_flax`` (``tcn_state_from_flax`` for a
TCN):

* each of the five classes: ``GatedMultiheadAttention`` with and without
  its gate (q, k and v interleaved per head), ``IntraEncoderBlock`` and a
  two-layer ``IntraModalTransformerEncoder`` (post-norm, gated),
  ``InterModalTransformerEncoder`` over two modalities and
  ``TCNAttentionBlock`` (softmax over the query axis under the causal
  mask, divided by sqrt(k) after it); each module's weights carried back
  by ``to_jax.module_flax_from_state`` bit for bit;
* ``TemporalConvNet(attention=1)`` in eval mode (B1's plain version on the
  CPU, block by block with the attention between), and one train step at
  dropout 0 (B3's plain version block by block): the loss and every
  gradient against ``jax.value_and_grad`` of ``fvt_tpu``'s;
* ``attn<i>`` carried through ``from_jax`` -> ``to_jax`` bit for bit at
  the model level (``temporal_<m>/attn<i>``).

Tolerances: outputs and the loss within 1e-5 of the largest value (fp32,
sums in another order); gradients within 1e-4 of their largest value.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.models import fusion_extra as jax_extra
from fvt_tpu.models.tcn import TemporalConvNet as FlaxTCN
from fvt_tpu_torch.models import fusion_extra
from fvt_tpu_torch.models.from_jax import (module_state_from_flax,
                                           state_from_flax,
                                           tcn_state_from_flax)
from fvt_tpu_torch.models.tcn import TemporalConvNet
from fvt_tpu_torch.models.to_jax import flax_from_state, module_flax_from_state

RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Under the suite's six workers torch's spinning intra-op threads
    made small CPU runs tens of times slower: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, seed):
    """A flax tree of ``shapes`` filled with numpy by leaf name."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ('scale', 'g'):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ('kernel', 'v'):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = rng.normal(0, 0.2, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _params(module, seed, *args, **kw):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.random.key(0))
    return _fill(shapes, seed)['params']


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _tree_equal(got, want, path=''):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_equal(got[k], want[k], f'{path}/{k}')
    else:
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


def _port(module, params):
    module.load_state_dict(module_state_from_flax(params), strict=True)
    _tree_equal(module_flax_from_state(module.state_dict()),
                jax.tree.map(np.asarray, params))
    return module


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize('gated', [False, True], ids=['plain', 'gated'])
def test_gated_multihead_attention(gated):
    x, gate = _x(1, 2, 7, 10), _x(2, 2, 4) if gated else None
    flax_mod = jax_extra.GatedMultiheadAttention(10, 12, 3)
    params = _params(flax_mod, 3, x, gate=gate)
    want = flax_mod.apply({'params': params}, x, gate=gate)
    port = _port(fusion_extra.GatedMultiheadAttention(10, 12, 3), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if gate is None else torch.from_numpy(gate))
    _close(got, want)


def test_intra_encoder_block():
    x, gate = _x(4, 2, 6, 12), _x(5, 2, 6)
    flax_mod = jax_extra.IntraEncoderBlock(12, 2, 20, dropout=0.1)
    params = _params(flax_mod, 6, x, gate=gate)
    want = flax_mod.apply({'params': params}, x, gate=gate)
    port = _port(fusion_extra.IntraEncoderBlock(12, 2, 20, dropout=0.1),
                 params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(gate))
    _close(got, want)


def test_intra_modal_transformer_encoder():
    x, gate = _x(7, 2, 5, 8), _x(8, 2, 4)
    flax_mod = jax_extra.IntraModalTransformerEncoder(2, 8, 2, 16)
    params = _params(flax_mod, 9, x, gate=gate)
    assert sorted(params) == ['layer0', 'layer1']
    want = flax_mod.apply({'params': params}, x, gate=gate)
    port = _port(fusion_extra.IntraModalTransformerEncoder(2, 8, 2, 16),
                 params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(gate))
    _close(got, want)


def test_inter_modal_transformer_encoder():
    mods, dims = ('vggish', 'bert'), {'vggish': 6, 'bert': 10}
    x = {m: _x(10 + i, 2, 5, dims[m]) for i, m in enumerate(mods)}
    flax_mod = jax_extra.InterModalTransformerEncoder(mods, dims, 8, 2,
                                                      dropout=0.1)
    params = _params(flax_mod, 12, x)
    want = flax_mod.apply({'params': params}, x)
    port = _port(fusion_extra.InterModalTransformerEncoder(
        mods, dims, 8, 2, dropout=0.1), params)
    with torch.no_grad():
        got = port({m: torch.from_numpy(v) for m, v in x.items()})
    _close(got, want)


def test_tcn_attention_block():
    x = _x(13, 2, 6, 9)
    flax_mod = jax_extra.TCNAttentionBlock(9, 9)
    params = _params(flax_mod, 14, x)
    want = flax_mod.apply({'params': params}, x)
    port = _port(fusion_extra.TCNAttentionBlock(9, 9, 9), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want)


# ------------------------------------------- TemporalConvNet(attention=1)
CIN, CHANNELS, K, B, T = 5, (8, 6), 3, 2, 12


@pytest.fixture(scope='module')
def attention_tcn():
    """fvt_tpu's TemporalConvNet(attention=1) at dropout 0, its params,
    the port's on them, an input."""
    x = _x(20, B, T, CIN)
    flax_mod = FlaxTCN(CHANNELS, kernel_size=K, dropout=0.0, attention=1,
                       max_length=T)
    params = _params(flax_mod, 21, x, train=False)
    assert {'attn0', 'attn1'} <= set(params)
    port = TemporalConvNet(CIN, CHANNELS, K, dropout=0.0, attention=1,
                           max_length=T)
    port.load_state_dict(tcn_state_from_flax(params), strict=True)
    return flax_mod, params, port, x


def test_attention_tcn_eval(attention_tcn):
    flax_mod, params, port, x = attention_tcn
    want = flax_mod.apply({'params': params}, x, train=False)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
        plain = port(torch.from_numpy(x), reference=True)
    _close(got, want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_attention_tcn_train_step(attention_tcn):
    """One train step at dropout 0: loss = mean(out * r) for a fixed r;
    the loss and the gradient of every parameter, the attention's too."""
    flax_mod, params, port, x = attention_tcn
    r = _x(22, B, T, CHANNELS[-1])

    def loss_fn(p):
        out = flax_mod.apply({'params': p}, x, train=True)
        return jnp.mean(out * r)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    port.zero_grad()
    loss = (port(torch.from_numpy(x), train=True,
                 generator=torch.Generator().manual_seed(0))
            * torch.from_numpy(r)).mean()
    loss.backward()
    _close(loss.detach(), want_loss)
    grads = {f'temporal.m.{k}': p.grad for k, p in port.named_parameters()}
    got_grads, _ = flax_from_state(grads)
    got_grads = got_grads['temporal_m']
    want_grads = jax.tree.map(np.asarray, want_grads)
    assert sorted(got_grads) == sorted(want_grads)
    flat_got = jax.tree_util.tree_leaves_with_path(got_grads)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    # a query bias adds the same logit to every query of a key, and the
    # softmax runs over the queries: its gradient is zero, both sides'
    # rounding noise, held against the largest gradient of all
    largest = max(float(np.abs(g).max()) for g in flat_want.values())
    for path, g in flat_got:
        want = flat_want[path]
        scale = float(np.abs(want).max())
        if 'query_layer' in jax.tree_util.keystr(path) \
                and path[-1].key == 'bias':
            assert scale < 1e-6 * largest, (path, scale)
            scale = largest
        err = float(np.abs(g - want).max())
        assert err <= GRAD_RTOL * scale, (jax.tree_util.keystr(path), err)


def test_attention_blocks_cross_the_bridge_both_ways(attention_tcn):
    _, params, _, _ = attention_tcn
    tree = jax.tree.map(np.asarray, {'temporal_vggish': params})
    state = state_from_flax(tree, {})
    assert 'temporal.vggish.attn.1.query_layer.weight' in state
    back, stats = flax_from_state(state)
    assert stats == {}
    _tree_equal(back, tree)
