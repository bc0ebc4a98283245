"""LFAN on ``logmel+bert``: the port against fvt_tpu, on the CPU (CAN's
cases, the same checks, are in ``tests/test_torch_logmel_can.py``).

Raw log-mel patches (B = 2, T = 2: 4 patches, drawn from a numpy seed) go
through the frozen VGGish in the model (``spatial.audio.backbone``; in
fvt_tpu ``spatial_audio``), then narrow TCNs and the family's fusion.
The weights are the port's seeded init (the VGGish's scaled to keep its
activations about 1 through its nine layers), carried to fvt_tpu's tree
with ``to_jax.flax_from_state``, ``spatial_audio`` included.

* eval logits within 1e-4 of their largest magnitude;
* one SGD step in float32 (loss rtol 1e-5, every parameter and running
  statistic after it rtol 1e-4 / atol 1e-5, the VGGish's bit for bit
  where they were: frozen, no weight decay) and one ADAM step in float64
  in both frameworks (the VGGish too: ``VGGish(dtype=float64)``, as
  fvt_tpu's takes any type), at the bounds
  ``tests/test_torch_families_train.py`` holds the families to.
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
from fvt_tpu.models.vggish import VGGish as FlaxVGGish
from fvt_tpu.train import optim as jax_optim
from fvt_tpu.train.steps import TrainState, make_train_step, split_frozen
from fvt_tpu_torch.config.defaults import get_train_config
from fvt_tpu_torch.models import models
from fvt_tpu_torch.models.from_jax import state_from_flax
from fvt_tpu_torch.models.to_jax import flax_from_state
from fvt_tpu_torch.models.vggish import VGGish
from fvt_tpu_torch.serve import serving_forward
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.steps import TrainStep

MODS = ('logmel', 'bert')
TCN = {'logmel': [8, 4], 'bert': [8, 4]}
ENC = {m: c[-1] for m, c in TCN.items()}
SETTINGS = {'logmel': {'input_dim': 128, 'channel': [8, 8],
                       'kernel_size': 5},
            'bert': {'input_dim': 768, 'channel': [8, 8], 'kernel_size': 3}}
B, T = 2, 2
EVAL_RTOL = 1e-4
ADAM_LOSS_RTOL = 1e-9
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


def _batch(dtype=np.float32):
    rng = np.random.default_rng(31)
    return {'logmel': rng.normal(size=(B, T, 96, 64)).astype(dtype),
            'bert': rng.normal(size=(B, T, 768)).astype(dtype),
            jax_constants.EXPR: rng.integers(0, 7, (B, T)).astype(np.int32)}


def _port_model(name, dtype=torch.float32):
    kw = dict(spatial_audio=VGGish(dtype), tcn_dropout=0.0,
              generator=torch.Generator().manual_seed(2))
    if name == 'LFAN':
        model = models.LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC,
                            fusion_dropout=0.0, **kw)
    else:
        model = models.CAN(MODS, 7, tcn_settings=SETTINGS, **kw)
    with torch.no_grad():  # He's gain over PyTorch's uniform init
        for p in model.spatial.audio.backbone.parameters():
            if p.dim() > 1:
                p.mul_(6 ** 0.5)
    return model


def _flax_model(name, dtype=jnp.float32):
    kw = dict(modality=MODS, output_dim=7, tcn_dropout=0.0,
              spatial_audio=FlaxVGGish(dtype=dtype))
    if name == 'LFAN':
        return jax_models.LFAN(tcn_channel=TCN, encoder_dim=ENC,
                               fusion_dropout=0.0, **kw)
    return jax_models.CAN(tcn_settings=SETTINGS, **kw)


@functools.lru_cache(maxsize=None)
def _initial(name):
    state = {k: v.clone() for k, v in _port_model(name).state_dict().items()}
    return state, flax_from_state(state, MODS)


def test_eval_logits_are_fvt_tpus():
    check_eval('LFAN')


@pytest.mark.parametrize('optimizer_name', ['SGD', 'ADAM'])
def test_one_step_in_lockstep(optimizer_name):
    check_step('LFAN', optimizer_name)


def check_eval(name):
    state, (params, stats) = _initial(name)
    assert set(params['spatial_audio']) == {
        *(f'conv{i}' for i in range(6)), 'fc0', 'fc1', 'fc2'}
    x = {k: v for k, v in _batch().items() if k in MODS}
    model = _flax_model(name)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {'params': params, 'batch_stats': stats},
        {k: jnp.asarray(v) for k, v in x.items()}))
    port = _port_model(name)
    port.load_state_dict(state_from_flax(params, stats, MODS), strict=True)
    got = serving_forward(port, {k: torch.from_numpy(v)
                                 for k, v in x.items()}).numpy()
    assert got.shape == (B, T, 7) and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 1e-3
    assert np.abs(got - want).max() <= EVAL_RTOL * scale


def _jax_step(name, optimizer_name, dtype):
    hp = jax_optim.standardize_opt_params(
        {**get_config(jax_constants.MELD),
         'opt__name_optimizer': optimizer_name})
    optimizer = jax_optim.build_optimizer(hp)
    x64 = dtype == np.float64
    model = _flax_model(name, jnp.float64 if x64 else jnp.float32)
    was_x64 = bool(jax.config.jax_enable_x64)
    jax.config.update('jax_enable_x64', x64)
    try:
        params, stats = jax.tree.map(lambda a: jnp.asarray(a.astype(dtype)),
                                     _initial(name)[1])
        state = TrainState(
            params=params, batch_stats=stats,
            opt_state=optimizer.init(split_frozen(params)[0]),
            step=jnp.zeros((), jnp.int32))
        state, loss = make_train_step(model, optimizer)(
            state, {k: jnp.asarray(v) for k, v in _batch(dtype).items()},
            jax.random.key(1))
        return float(loss), jax.tree.map(np.asarray, (state.params,
                                                      state.batch_stats))
    finally:
        jax.config.update('jax_enable_x64', was_x64)


def check_step(name, optimizer_name):
    adam = optimizer_name == 'ADAM'
    dtype = np.float64 if adam else np.float32
    want_loss, (end_params, end_stats) = _jax_step(name, optimizer_name,
                                                   dtype)
    start = _initial(name)[0]
    model = _port_model(name, torch.float64 if adam else torch.float32)
    model.load_state_dict(start, strict=True)
    model.to(torch.float64 if adam else torch.float32)
    hp = optim.standardize_opt_params(
        {**get_train_config(), 'opt__name_optimizer': optimizer_name})
    step = TrainStep(model, hp, 'cpu')
    assert all(k.startswith('spatial.') for k in
               {k for k, _ in model.named_parameters()} - set(step.trainable))
    loss = float(step(_batch(dtype), torch.Generator().manual_seed(0)))
    assert loss == pytest.approx(want_loss,
                                 rel=ADAM_LOSS_RTOL if adam else 1e-5)
    want = state_from_flax(end_params, end_stats, MODS)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith('num_batches_tracked'):
            assert int(got[key]) == 1
            continue
        if key.startswith('spatial.'):
            # frozen: no gradient, no weight decay, no momentum
            assert torch.equal(got[key].float(), start[key]), key
            assert torch.equal(w, start[key]), key
            continue
        g = got[key].float().numpy()
        if adam:
            np.testing.assert_allclose(g, w.numpy(), rtol=ADAM_PARAM_RTOL,
                                       atol=ADAM_PARAM_ATOL, err_msg=key)
        else:
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=key)
