"""The port's optimizers and schedules against fvt_tpu.train.optim.

The six schedules give the same lr for epochs 0-60 (to 1e-12; MYWARMUP
on a seeded metric sequence, through a ``state_dict`` round trip), the
silent base lr is reproduced, and single SGD steps (dampening, Nesterov)
and Adam steps match fvt_tpu's optax re-implementation on a seeded tensor
(1e-6), since the port's optimizers are ``torch.optim``'s own.
"""
import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from fvt_tpu import constants as jax_constants
from fvt_tpu.config.defaults import get_config
from fvt_tpu.train import optim as jax_optim
from fvt_tpu_torch import constants
from fvt_tpu_torch.config.defaults import get_train_config
from fvt_tpu_torch.train import optim

SCHEDULES = ['STEP', 'MULTISTEP', 'MYSTEP', 'COSINE', 'MYCOSINE', 'MYWARMUP']


def _hps(**overrides):
    opt = {f'opt__{k}': v for k, v in overrides.items()}
    return (jax_optim.standardize_opt_params(
                {**get_config(jax_constants.MELD), **opt}),
            optim.standardize_opt_params({**get_train_config(), **opt}))


@pytest.mark.parametrize('name', SCHEDULES)
@pytest.mark.parametrize('honor_lr', [False, True])
def test_schedule_matches_fvt_tpu(name, honor_lr):
    jhp, hp = _hps(name_lr_scheduler=name, lr=0.01, honor_lr=honor_lr,
                   step_size=7, milestone='5+20+41', t_max=50, patience=2)
    want = jax_optim.build_scheduler(jhp, 60, 5)
    got = optim.build_scheduler(hp, 60, 5)
    metrics = np.random.default_rng(0).random(61)
    for epoch in range(61):
        assert got.lr(epoch) == pytest.approx(want.lr(epoch), abs=1e-12)
        metric = float(metrics[epoch]) if name == 'MYWARMUP' else None
        assert got.step(epoch, metric) == pytest.approx(
            want.step(epoch, metric), abs=1e-12)
        if epoch == 30:  # resume: the state survives a round trip
            fresh = optim.build_scheduler(hp, 60, 5)
            fresh.load_state_dict(got.state_dict())
            assert fresh.state_dict() == want.state_dict()
            got = fresh
    if name == 'MYWARMUP':
        assert got.current_lr < 0.01  # the plateau rule did fire


def test_no_scheduler_when_switched_off():
    _, hp = _hps(lr_scheduler=False)
    assert optim.build_scheduler(hp, 60, 5) is None


def test_effective_base_lr_ignores_opt_lr_unless_honoured():
    jhp, hp = _hps(lr=0.05)
    assert optim.effective_base_lr(hp) == jax_optim.effective_base_lr(jhp) \
        == optim.TORCH_DEFAULT_LR == 1e-3
    jhp, hp = _hps(lr=0.05, honor_lr=True)
    assert optim.effective_base_lr(hp) == jax_optim.effective_base_lr(jhp) \
        == 0.05
    p = torch.nn.Parameter(torch.zeros(2))
    opt = optim.build_optimizer(_hps(lr=0.05)[1], [p])
    assert optim.get_lr(opt) == 1e-3
    optim.set_lr(opt, 0.25)
    assert optim.get_lr(opt) == 0.25 == opt.param_groups[0]['lr']


def test_parse_milestones_and_standardize():
    for raw in (None, '0', '5+20', '5,20', [5, 20]):
        assert optim.parse_milestones(raw) == jax_optim.parse_milestones(raw)
    hp = optim.standardize_opt_params({'mode': 'TRAINING',
                                       'opt__mode': constants.MIN_MODE,
                                       'seed': 3})
    assert hp.mode == constants.MIN_MODE and hp.seed == 3


@pytest.mark.parametrize('overrides', [
    dict(name_optimizer='SGD'),                                # Nesterov
    dict(name_optimizer='SGD', nesterov=False, dampening=0.5),
    dict(name_optimizer='SGD', nesterov=False, momentum=0.0),
    dict(name_optimizer='ADAM'),
], ids=['nesterov', 'dampening', 'plain', 'adam'])
def test_optimizer_steps_match_fvt_tpu(overrides):
    """Three updates of one seeded tensor under seeded gradients."""
    jhp, hp = _hps(**overrides)
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(4, 5)).astype(np.float32)
    grads = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(3)]

    tx = jax_optim.build_optimizer(jhp)
    params = {'w': jnp.asarray(w0)}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = optim.build_optimizer(hp, [p])
    for g in grads:
        updates, state = tx.update({'w': jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params['w']), rtol=0,
                                   atol=1e-6)


def test_nesterov_with_dampening_is_refused():
    _, hp = _hps(name_optimizer='SGD', nesterov=True, dampening=0.5)
    with pytest.raises(ValueError, match='dampening=0'):
        optim.build_optimizer(hp, [torch.nn.Parameter(torch.zeros(1))])
