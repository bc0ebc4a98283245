"""Lockstep training of CAN and JMT: the port's TrainStep against fvt_tpu's.

Narrow CAN and JMT on ``video`` (as 512-d features) + ``vggish`` +
``bert`` at dropout 0 take 3 optimizer steps in both frameworks from the
same weights (the port's seeded init, which draws fvt_tpu's
distributions, carried to fvt_tpu's tree with ``to_jax.flax_from_state``)
on the same numpy batches, under SGD
(momentum 0.9, Nesterov) and ADAM, both with fvt_tpu's default weight
decay 1e-4.  The port runs on the CPU, where the fused train wrapper takes
its plain version.  JMT fuses ``video`` and ``vggish`` only: its ``bert``
TCN and BatchNorm get no gradient, and fvt_tpu's optax chain
(``add_decayed_weights`` before the trace or Adam) still decays them and
keeps their momentum; so does the port.  JMT trains without a mask, its
final attention over the B*T frames of the batch, as in fvt_tpu.

SGD runs in float32, the production type: per-step loss rtol 1e-5,
parameters and BatchNorm running statistics after step 3 rtol 1e-4 /
atol 1e-5.  ADAM runs in float64 in both frameworks (the parameters,
the batches and the optimizer state; fvt_tpu under ``jax_enable_x64``),
as fvt_tpu's own ``tests/test_lockstep.py`` holds its families: Adam's
first steps move an element by about lr whatever its gradient's size, so
an element whose gradient is near the float32 noise moves by a share of
lr or the other way, and fvt_tpu's float32 gradients on the CPU are that
noisy (against a float64 run, about 1e-4 of a tensor's largest element;
the port's mostly 1e-5; measured on JMT).  In float64 every element is held: the
losses at rtol ``ADAM_LOSS_RTOL`` and every parameter and running
statistic at rtol ``ADAM_PARAM_RTOL`` (the bridge carries values as
float32, so that is its rounding) and atol ``ADAM_PARAM_ATOL``.

The weights are an init of the models, not numpy draws by leaf name (as
``test_torch_families.py`` takes): with those, CAN's gating leaves fc1's
outputs a spread near sqrt(BatchNorm's eps) across these 24 frames, so
bn1 in train mode multiplies the frameworks' float32 differences before
it by ~200, past the SGD tolerances (measured on the CPU).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu import constants as jax_constants
from fvt_tpu.config.defaults import get_config
from fvt_tpu.models import models as jax_models
from fvt_tpu.train import optim as jax_optim
from fvt_tpu.train.steps import TrainState, make_train_step, split_frozen
from fvt_tpu_torch.config.defaults import get_train_config
from fvt_tpu_torch.models import models
from fvt_tpu_torch.models.from_jax import state_from_flax
from fvt_tpu_torch.models.to_jax import flax_from_state
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.steps import TrainStep

MODS = ('video', 'vggish', 'bert')
SETTINGS = {'video': {'input_dim': 512, 'channel': [8, 128],
                      'kernel_size': 5},
            'vggish': {'input_dim': 128, 'channel': [8, 8],
                       'kernel_size': 5},
            'bert': {'input_dim': 768, 'channel': [8, 8], 'kernel_size': 3}}
B, T, STEPS = 2, 12, 3
# measured 7e-14 (JMT)
ADAM_LOSS_RTOL = 1e-9
# twice float32's unit roundoff: what ``state_from_flax`` rounds to.
# An element whose gradient is 0 but for float64 rounding, and which
# starts at 0, is moved by lr * g / (|g| + eps) alone, differently in the
# two frameworks: the key thirds of the in_proj biases (a key bias shifts
# a row's logits alike) and the value third of the final self-attention's
# (bn1 takes what it adds, a constant over the frames, out).  Measured:
# 2.4e-9 at most (JMT), against steps of about lr = 1e-3
ADAM_PARAM_RTOL, ADAM_PARAM_ATOL = 1.2e-7, 2e-8


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made small CPU runs tens of times
    slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(dtype=np.float32):
    rng = np.random.default_rng(21)
    return [{'video': rng.normal(size=(B, T, 512)).astype(dtype),
             'vggish': rng.normal(size=(B, T, 128)).astype(dtype),
             'bert': rng.normal(size=(B, T, 768)).astype(dtype),
             jax_constants.EXPR: rng.integers(0, 7, (B, T)).astype(np.int32)}
            for _ in range(STEPS)]


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_model(name: str):
    kw = dict(modality=MODS, output_dim=7, tcn_settings=SETTINGS,
              tcn_dropout=0.0)
    return (jax_models.CAN(**kw) if name == 'CAN'
            else jax_models.JMT(model_name=name, **kw))


def _port_model(name: str):
    kw = dict(tcn_settings=SETTINGS, tcn_dropout=0.0)
    return (models.CAN(MODS, 7, **kw) if name == 'CAN'
            else models.JMT(MODS, 7, model_name=name, **kw))


@functools.lru_cache(maxsize=None)
def _initial(name: str):
    """The port's initial state of ``name`` less the ArcFace, which
    ``video`` as features leaves out, and fvt_tpu's (params, batch_stats)
    of the same values (fvt_tpu's jitted init took 4-6 s to compile)."""
    state = {k: v.clone() for k, v in _port_model(name).state_dict().items()
             if not k.startswith('spatial.')}
    return state, flax_from_state(state, MODS)


def _jax_run(name: str, optimizer_name: str, dtype):
    """(per-step losses, final variables) of 3 steps of fvt_tpu's train
    step from :func:`_initial`, in ``dtype``."""
    hp = jax_optim.standardize_opt_params(
        {**get_config(jax_constants.MELD),
         'opt__name_optimizer': optimizer_name})
    optimizer = jax_optim.build_optimizer(hp)
    model = _flax_model(name)
    x64 = dtype == np.float64
    was_x64 = bool(jax.config.jax_enable_x64)
    jax.config.update('jax_enable_x64', x64)
    try:
        params, stats = jax.tree.map(
            lambda a: jnp.asarray(a.astype(dtype)), _initial(name)[1])
        state = TrainState(
            params=params, batch_stats=stats,
            opt_state=optimizer.init(split_frozen(params)[0]),
            step=jnp.zeros((), jnp.int32))
        step = make_train_step(model, optimizer)
        losses = []
        for batch in _batches(dtype):
            state, loss = step(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                               jax.random.key(1))
            losses.append(float(loss))
        return losses, (_numpy_tree(state.params),
                        _numpy_tree(state.batch_stats))
    finally:
        jax.config.update('jax_enable_x64', was_x64)


@pytest.mark.parametrize('optimizer_name', ['SGD', 'ADAM'])
@pytest.mark.parametrize('name', ['CAN', 'JMT'])
def test_three_steps_in_lockstep(name, optimizer_name):
    dtype = np.float64 if optimizer_name == 'ADAM' else np.float32
    want_losses, (end_params, end_stats) = _jax_run(name, optimizer_name,
                                                    dtype)
    model = _port_model(name)
    start = _initial(name)[0]
    missing, unexpected = model.load_state_dict(start, strict=False)
    assert not unexpected and all(k.startswith('spatial.') for k in missing)
    model.to(torch.float64 if dtype == np.float64 else torch.float32)
    hp = optim.standardize_opt_params(
        {**get_train_config(), 'opt__name_optimizer': optimizer_name})
    assert hp.weight_decay > 0
    step = TrainStep(model, hp, 'cpu')
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(batch, gen)) for batch in _batches(dtype)]
    np.testing.assert_allclose(
        losses, want_losses,
        rtol=ADAM_LOSS_RTOL if optimizer_name == 'ADAM' else 1e-5)

    want = state_from_flax(end_params, end_stats, MODS)
    got = {k: v for k, v in model.state_dict().items()
           if not k.startswith('spatial.')}
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith('num_batches_tracked'):
            assert int(got[key]) == STEPS
            continue
        g = got[key]
        assert g.dtype == (torch.float64 if dtype == np.float64
                           else torch.float32), key
        # compared as the bridge carries fvt_tpu's values: float32
        g, w = g.float().numpy(), w.numpy()
        if optimizer_name == 'ADAM':
            np.testing.assert_allclose(g, w, rtol=ADAM_PARAM_RTOL,
                                       atol=ADAM_PARAM_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=key)
        if 'running_' not in key and start[key].any():
            # every trainable tensor moved, bert's in JMT too
            assert not np.array_equal(g, start[key].numpy()), key
    if name == 'JMT':
        # bert's TCN is outside JMT's loss: it moved by weight decay and
        # momentum alone, as in fvt_tpu
        assert all(p.grad is not None and not p.grad.any()
                   for k, p in model.named_parameters()
                   if k.startswith(('temporal.bert.', 'bn.bert.')))
