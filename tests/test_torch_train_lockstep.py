"""Lockstep training: the port's TrainStep against fvt_tpu's train step.

A narrow ``vggish+bert`` LFAN at dropout 0 takes 3 optimizer steps in
both frameworks from the same weights (carried over with
``state_from_flax``) on the same numpy batches.  The JAX side runs
``make_train_step`` with ``tcn_fused=True`` (the Pallas train kernels in
interpret mode); the port runs on the CPU, where the fused wrapper takes
its plain version.  Tolerances: per-step loss rtol 1e-5; parameters after
step 3 rtol 2e-4 / atol 1e-5 (those of ``tests/test_tcn_pallas.py``);
BatchNorm running statistics rtol 1e-5, which pins the unbiased-variance
EMA at momentum 0.1.

Adam moves an element by ``lr * m / (sqrt(v) + eps)``, about lr whatever
the gradient's size, so where a gradient element lies within fp32
rounding of 0 the direction of its update is noise in both frameworks.
Under ADAM the parameter tolerance therefore holds for all but at most
0.1% of a tensor's elements, and those stay within what Adam can move in
3 steps (``2 * 3 * lr``).  Under SGD it holds for every element.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu import constants as jax_constants
from fvt_tpu.config.defaults import get_config
from fvt_tpu.models.models import LFAN as FlaxLFAN
from fvt_tpu.train import optim as jax_optim
from fvt_tpu.train.steps import create_train_state, make_train_step
from fvt_tpu_torch.config.defaults import get_train_config
from fvt_tpu_torch.models.from_jax import state_from_flax
from fvt_tpu_torch.models.models import LFAN, batchnorm_frames
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.steps import TrainStep, eval_step
from fvt_tpu_torch.train.trainer import Trainer

MODS = ('vggish', 'bert')
TCN = {'vggish': [8, 8, 4, 4], 'bert': [8, 8, 4, 4]}
ENC = {m: c[-1] for m, c in TCN.items()}
B, T, STEPS = 2, 16, 3


def _batches():
    rng = np.random.default_rng(11)
    return [{'vggish': rng.normal(size=(B, T, 128)).astype(np.float32),
             'bert': rng.normal(size=(B, T, 768)).astype(np.float32),
             jax_constants.EXPR: rng.integers(0, 7, (B, T)).astype(np.int32)}
            for _ in range(STEPS)]


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_run(optimizer_name: str):
    """(initial variables, per-step losses, final variables) of 3 steps of
    fvt_tpu's train step; one run per optimizer serves every case."""
    hp = jax_optim.standardize_opt_params(
        {**get_config(jax_constants.MELD),
         'opt__name_optimizer': optimizer_name})
    optimizer = jax_optim.build_optimizer(hp)
    model = FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=TCN,
                     encoder_dim=ENC, tcn_dropout=0.0, fusion_dropout=0.0,
                     tcn_fused=True)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches()]
    state = create_train_state(model, optimizer, batches[0],
                               jax.random.key(0))
    first = (_numpy_tree(state.params), _numpy_tree(state.batch_stats))
    step = make_train_step(model, optimizer)
    losses = []
    for batch in batches:
        state, loss = step(state, batch, jax.random.key(1))
        losses.append(float(loss))
    return first, losses, (_numpy_tree(state.params),
                           _numpy_tree(state.batch_stats))


def _port_hp(optimizer_name: str):
    return optim.standardize_opt_params(
        {**get_train_config(), 'opt__name_optimizer': optimizer_name})


@pytest.mark.parametrize('optimizer_name', ['SGD', 'ADAM'])
@pytest.mark.parametrize('fused', [True, False])
def test_three_steps_in_lockstep(fused, optimizer_name):
    (params, stats), want_losses, (end_params, end_stats) = _jax_run(
        optimizer_name)
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC, tcn_dropout=0.0,
                 fusion_dropout=0.0)
    model.load_state_dict(state_from_flax(params, stats, MODS),
                          strict=True)
    step = TrainStep(model, _port_hp(optimizer_name), 'cpu', tcn_fused=fused)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(batch, gen)) for batch in _batches()]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)

    want = state_from_flax(end_params, end_stats, MODS)
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            assert int(got[name]) == STEPS
            continue
        stat = 'running_' in name
        g, w = got[name].numpy(), w.numpy()
        if optimizer_name == 'ADAM' and not stat:
            off = ~np.isclose(g, w, rtol=2e-4, atol=1e-5)
            assert off.mean() <= 1e-3, (name, off.sum())
            assert np.abs(g - w).max() <= 2 * STEPS * 1e-3, name
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-5 if stat else 2e-4,
                atol=1e-7 if stat else 1e-5, err_msg=name)
        moved += not stat
    assert moved == len(step.trainable)


def test_batchnorm_train_is_batchnorm1d_on_the_frame_view():
    """The train-mode BatchNorm equals ``nn.BatchNorm1d`` in train mode on
    the (B*T, C) view, output and running statistics, bit for bit."""
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC)
    h = torch.from_numpy(np.random.default_rng(3).normal(
        1.0, 2.0, size=(B, T, 4)).astype(np.float32))
    twin = torch.nn.BatchNorm1d(4).train()
    want = twin(h.reshape(B * T, 4)).reshape(B, T, 4)
    got = batchnorm_frames(model.bn['bert'], h, True)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())
    for name in ('running_mean', 'running_var', 'num_batches_tracked'):
        np.testing.assert_array_equal(getattr(model.bn['bert'], name).numpy(),
                                      getattr(twin, name).numpy())
    # the unbiased variance went into the EMA, momentum 0.1
    var = h.reshape(-1, 4).var(0, unbiased=True)
    np.testing.assert_allclose(model.bn['bert'].running_var.numpy(),
                               (0.9 + 0.1 * var).numpy(), rtol=1e-6)


def _dropout_trainer(seed: int) -> Trainer:
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC, tcn_dropout=0.1,
                 fusion_dropout=0.1,
                 generator=torch.Generator().manual_seed(0))
    return Trainer(model, {**get_train_config(), 'seed': seed,
                           'nan_guard': True}, 'cpu')


def test_dropout_follows_the_seed():
    batches = _batches()[:2]
    a = _dropout_trainer(5).train_one_epoch(batches, 0)
    b = _dropout_trainer(5).train_one_epoch(batches, 0)
    c = _dropout_trainer(6).train_one_epoch(batches, 0)
    assert np.isfinite(a)
    assert a == b
    assert a != c


def test_trainer_steps_the_schedule_and_guards_the_loss():
    config = {**get_train_config(), 'opt__step_size': 1, 'nan_guard': True}
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC, tcn_dropout=0.0,
                 fusion_dropout=0.0)
    trainer = Trainer(model, config, 'cpu')
    batches = _batches()[:2]
    assert optim.get_lr(trainer.optimizer) == pytest.approx(1e-3)
    mean = trainer.train_one_epoch(batches, 0)
    assert len(trainer.step_losses) == 2
    assert mean == pytest.approx(sum(trainer.step_losses) / 2)
    assert optim.get_lr(trainer.optimizer) == pytest.approx(1e-4)
    bad = dict(batches[0], vggish=np.full((B, T, 128), np.nan, np.float32))
    with pytest.raises(FloatingPointError, match='non-finite loss'):
        trainer.train_one_epoch([bad], 1)


def test_eval_step_uses_running_statistics_and_no_dropout():
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC)
    inputs = {k: v for k, v in _batches()[0].items() if k in MODS}
    a = eval_step(model, inputs, 'cpu')
    b = eval_step(model, inputs, 'cpu', reference=True)
    assert a.shape == (B, T, 7)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_training_needs_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip('needs a machine without a CUDA card')
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TrainStep(model, _port_hp('SGD'))


def test_fusion_kernel_wrapper_refuses_tensors_that_need_grad():
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC)
    feats = {m: torch.zeros(B, T, 4) for m in MODS}
    with pytest.raises(RuntimeError, match='no backward'):
        model.fusion(feats)  # eval path, grad mode on, parameters need grad
    with torch.no_grad():
        assert model.fusion(feats).shape == (B, T, 64)
    out = model.fusion(feats, True, torch.Generator().manual_seed(0))
    assert out.requires_grad


def test_training_a_video_modality_is_refused_for_now():
    """Refused until tri-modal training was ported; now a precomputed
    video stream passes to the model as it is, and a video model's raw
    crops go through the frozen backbone in train mode: its running
    statistics move, its parameters get no gradient, the head's do."""
    model = LFAN(('vggish',), 7, tcn_channel=TCN, encoder_dim=ENC)
    x = {'vggish': torch.zeros(1, 4, 128), 'video': torch.zeros(1, 4, 512)}
    out = model(x, True, torch.Generator().manual_seed(0))
    assert out.shape == (1, 4, 7)

    mods = ('video', 'vggish')
    model = LFAN(mods, 7, tcn_channel={m: TCN['vggish'] for m in mods},
                 encoder_dim={m: ENC['vggish'] for m in mods})
    bn = model.spatial.visual.backbone.input_layer[1]
    before = bn.running_mean.clone()
    x = {'vggish': torch.randn(1, 2, 128),
         'video': torch.rand(1, 2, 40, 40, 3) * 2 - 1}
    model(x, True, torch.Generator().manual_seed(0)).sum().backward()
    assert not torch.equal(bn.running_mean, before)
    assert int(bn.num_batches_tracked) == 1
    assert all(p.grad is None
               for p in model.spatial.parameters())
    assert all(p.grad is not None
               for p in model.regressor.parameters())


# the REGRESSION leg (fvt_tpu's LFAN_REG, ``tests/test_lockstep.py``): the
# tanh head under the CCC loss.  SGD in float32 (losses rtol 1e-5,
# parameters 1e-4 / 1e-5); ADAM in float64 in both frameworks, at the
# bounds ``tests/test_torch_families_train.py`` holds CAN and JMT to
REG_ADAM_LOSS_RTOL = 1e-9
REG_ADAM_PARAM_RTOL, REG_ADAM_PARAM_ATOL = 1.2e-7, 2e-8


def _regression_batches(dtype):
    rng = np.random.default_rng(12)
    return [{'vggish': rng.normal(size=(B, T, 128)).astype(dtype),
             'bert': rng.normal(size=(B, T, 768)).astype(dtype),
             'VA_continuous_label': rng.uniform(-1, 1, (B, T)).astype(dtype)}
            for _ in range(STEPS)]


def _regression_model():
    return LFAN(MODS, 1, task='REGRESSION', tcn_channel=TCN,
                encoder_dim=ENC, tcn_dropout=0.0, fusion_dropout=0.0,
                generator=torch.Generator().manual_seed(4))


def _jax_regression_run(optimizer_name: str, start: dict, dtype):
    """(per-step losses, final variables) of fvt_tpu's REGRESSION train
    step from the port's ``start`` state, in ``dtype``."""
    from fvt_tpu.train.steps import TrainState, split_frozen
    from fvt_tpu_torch.models.to_jax import flax_from_state

    hp = jax_optim.standardize_opt_params(
        {**get_config(jax_constants.MELD),
         'opt__name_optimizer': optimizer_name})
    optimizer = jax_optim.build_optimizer(hp)
    model = FlaxLFAN(modality=MODS, output_dim=1,
                     task=jax_constants.REGRESSION, tcn_channel=TCN,
                     encoder_dim=ENC, tcn_dropout=0.0, fusion_dropout=0.0)
    was_x64 = bool(jax.config.jax_enable_x64)
    jax.config.update('jax_enable_x64', dtype == np.float64)
    try:
        params, stats = jax.tree.map(lambda a: jnp.asarray(a.astype(dtype)),
                                     flax_from_state(start, MODS))
        state = TrainState(
            params=params, batch_stats=stats,
            opt_state=optimizer.init(split_frozen(params)[0]),
            step=jnp.zeros((), jnp.int32))
        step = make_train_step(model, optimizer,
                               task=jax_constants.REGRESSION)
        losses = []
        for batch in _regression_batches(dtype):
            state, loss = step(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                               jax.random.key(1))
            losses.append(float(loss))
        return losses, (_numpy_tree(state.params),
                        _numpy_tree(state.batch_stats))
    finally:
        jax.config.update('jax_enable_x64', was_x64)


@pytest.mark.parametrize('optimizer_name', ['SGD', 'ADAM'])
def test_three_regression_steps_in_lockstep(optimizer_name):
    adam = optimizer_name == 'ADAM'
    dtype = np.float64 if adam else np.float32
    model = _regression_model()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    want_losses, (end_params, end_stats) = _jax_regression_run(
        optimizer_name, start, dtype)
    model.to(torch.float64 if adam else torch.float32)
    step = TrainStep(model, _port_hp(optimizer_name), 'cpu',
                     task='REGRESSION')
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(batch, gen))
              for batch in _regression_batches(dtype)]
    assert all(0 < l < 2 for l in losses)
    np.testing.assert_allclose(losses, want_losses,
                               rtol=REG_ADAM_LOSS_RTOL if adam else 1e-5)
    want = state_from_flax(end_params, end_stats, MODS)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            assert int(got[name]) == STEPS
            continue
        g, w = got[name].float().numpy(), w.numpy()
        if adam:
            np.testing.assert_allclose(g, w, rtol=REG_ADAM_PARAM_RTOL,
                                       atol=REG_ADAM_PARAM_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        if 'running_' not in name and start[name].any():
            assert not np.array_equal(g, start[name].numpy()), name
