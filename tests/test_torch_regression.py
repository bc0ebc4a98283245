"""The regression task's pieces of the port against fvt_tpu's, on the CPU:
the CCC loss and score (``train/losses.py``), ``compute_regression_perf``,
``ParamControl``'s freeze and release (``train/param_control.py``) and
the trainer's CSV and plots (``train/regression_viz.py``).

* ``ccc`` and ``ccc_loss`` on the same numpy arrays within 1e-6 (float32;
  exactly their formula in float64), with weights; ``ccc_score`` and
  ``compute_regression_perf`` equal (float64 numpy in both), the
  (n-1)/n of identical arrays included;
* ``path_mask`` and ``freeze`` select the same tensors as fvt_tpu's for a
  user's patterns (regexes over fvt_tpu's flax paths, matched through
  ``from_jax``'s table, never through torch names), and a frozen tensor
  gets no update, no weight decay and no momentum;
* ``ParamControl``'s stages, releases and exhaustion step for step as
  fvt_tpu's.
"""
import csv
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.train import losses as jax_losses
from fvt_tpu.train import metrics as jax_metrics
from fvt_tpu.train import param_control as jax_pc
from fvt_tpu_torch.config.defaults import get_train_config
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.models.to_jax import flax_from_state
from fvt_tpu_torch.train import losses, metrics, optim
from fvt_tpu_torch.train import param_control as pc
from fvt_tpu_torch.train import regression_viz as RV
from fvt_tpu_torch.train.steps import TrainStep, split_frozen

MODS = ('vggish', 'bert')
TCN = {'vggish': [8, 8, 4, 4], 'bert': [8, 8, 4, 4]}
ENC = {m: c[-1] for m, c in TCN.items()}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made small CPU runs tens of times
    slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, shape=(3, 40)):
    rng = np.random.default_rng(seed)
    gold = rng.uniform(-1, 1, shape)
    return gold, np.tanh(gold + 0.5 * rng.normal(size=shape))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_ccc_and_ccc_loss_are_fvt_tpus(dtype):
    gold, pred = (a.astype(dtype) for a in _pair())
    weights = np.random.default_rng(1).uniform(0, 2, gold.shape) \
        .astype(dtype)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_losses.ccc(jnp.asarray(gold),
                                         jnp.asarray(pred)))
        want_loss = float(jax_losses.ccc_loss(jnp.asarray(gold),
                                              jnp.asarray(pred)))
        want_w = float(jax_losses.ccc_loss(jnp.asarray(gold),
                                           jnp.asarray(pred),
                                           jnp.asarray(weights)))
    g, p = torch.from_numpy(gold), torch.from_numpy(pred)
    got = losses.ccc(g, p)
    assert got.shape == gold.shape and got.dtype == g.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert float(losses.ccc_loss(g, p)) == pytest.approx(want_loss, abs=tol)
    assert float(losses.ccc_loss(g, p, torch.from_numpy(weights))) == \
        pytest.approx(want_w, abs=tol)


def test_ccc_loss_of_a_perfect_fit_and_its_gradient():
    gold = torch.linspace(-1, 1, 20, dtype=torch.float64).reshape(2, 10)
    pred = gold.clone().requires_grad_(True)
    loss = losses.ccc_loss(gold, pred)
    loss.backward()
    assert torch.isfinite(pred.grad).all()
    # elementwise numerator: a perfect fit is not a zero loss
    want = float(jax_losses.ccc_loss(jnp.asarray(gold.numpy()),
                                     jnp.asarray(gold.numpy())))
    assert float(loss.detach()) == pytest.approx(want, rel=1e-6)


def test_ccc_score_and_regression_perf_are_fvt_tpus():
    rng = np.random.default_rng(3)
    data = {}
    for i in range(4):
        n = int(rng.integers(20, 61))
        lab = rng.uniform(-1.0, 1.0, size=n)
        data[f'vid{i}'] = {'labels': lab,
                           'preds': np.tanh(lab + 0.3 * rng.normal(size=n))}
    assert metrics.compute_regression_perf(data) == \
        jax_metrics.compute_regression_perf(data)
    gold, pred = _pair(4, (50,))
    assert losses.ccc_score(gold, pred) == jax_losses.ccc_score(gold, pred)
    # identical arrays: a ddof-0 covariance over ddof-1 variances
    ident = {k: {'labels': v['labels'], 'preds': v['labels']}
             for k, v in data.items()}
    n = sum(len(v['labels']) for v in data.values())
    perf = metrics.compute_regression_perf(ident)
    assert perf == jax_metrics.compute_regression_perf(ident)
    assert abs(perf['ccc'] - (n - 1) / n) < 1e-9 and perf['rmse'] < 1e-12
    flat = {'v': {'labels': np.zeros(5), 'preds': np.ones(5)}}
    assert metrics.compute_regression_perf(flat)['pcc'] == 0.0


def _model(seed=0):
    return LFAN(MODS, 1, task='REGRESSION', tcn_channel=TCN,
                encoder_dim=ENC, tcn_dropout=0.0, fusion_dropout=0.0,
                generator=torch.Generator().manual_seed(seed))


PATTERNS = ([], [r'temporal'], [r'fusion', r'regressor', r'bn_'],
            [r'^temporal_bert/block[01]/conv1/', r'/downsample/'],
            [r'nothing matches'])


@pytest.mark.parametrize('patterns', PATTERNS)
def test_path_mask_selects_fvt_tpus_tensors(patterns):
    model = _model()
    trainable, frozen = split_frozen(model)
    assert not frozen
    params, _ = flax_from_state(model.state_dict(), MODS)
    want = jax_pc.path_mask(params, patterns)
    flat = {'/'.join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = pc.path_mask(trainable, patterns)
    assert sorted(pc.flax_path(n) for n in got) == sorted(flat)
    for name, on in got.items():
        assert on == flat[pc.flax_path(name)], name
    with pytest.raises(KeyError):
        pc.flax_path('bn.bert.running_mean')


def _hp(name):
    return optim.standardize_opt_params(
        {**get_train_config(), 'opt__name_optimizer': name,
         'opt__weight_decay': 0.1})


@pytest.mark.parametrize('name', ['SGD', 'ADAM'])
def test_freeze_leaves_frozen_tensors_untouched(name):
    """Two SGD (or ADAM) steps under ``freeze(['regressor', 'bn_bert'])``:
    the regressor and bert's BatchNorm move; every other parameter is
    bit for bit where it was, though each has a gradient and the decay is
    0.1."""
    model = _model()
    hp = _hp(name)
    step = TrainStep(model, hp, 'cpu', task='REGRESSION')
    step.optimizer = pc.freeze(hp, step.trainable, ['regressor', 'bn_bert'])
    before = {k: v.detach().clone() for k, v in step.trainable.items()}
    rng = np.random.default_rng(5)
    batch = {'vggish': rng.normal(size=(2, 10, 128)).astype(np.float32),
             'bert': rng.normal(size=(2, 10, 768)).astype(np.float32),
             'VA_continuous_label': rng.uniform(-1, 1, (2, 10))
             .astype(np.float32)}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(batch, gen)
    for k, v in step.trainable.items():
        moved = not torch.equal(v.detach(), before[k])
        assert v.grad is not None, k
        assert moved == (k.startswith('regressor') or k.startswith(
            'bn.bert')), k
    empty = pc.freeze(hp, step.trainable, ['nothing matches'])
    assert sum(len(g['params']) for g in empty.param_groups) == 0


def test_param_control_stages_as_fvt_tpus():
    model = _model()
    trainable, _ = split_frozen(model)
    hp = _hp('SGD')
    args = ([[r'temporal_vggish'], [r'temporal_bert']], 2,
            [r'fusion', r'regressor', r'bn_'])
    port, ref = pc.ParamControl(*args), jax_pc.ParamControl(*args)
    params, _ = flax_from_state(model.state_dict(), MODS)
    import optax
    for _ in range(4):
        assert port.current_patterns() == ref.current_patterns()
        assert port.can_release() == ref.can_release()
        opt = port.release(hp, trainable)
        ref.release(optax.sgd(0.1), params)
        assert (port.released, port.release_count, port.early_stop) == \
            (ref.released, ref.release_count, ref.early_stop)
        selected = {id(p) for g in opt.param_groups for p in g['params']}
        mask = pc.path_mask(trainable, port.current_patterns())
        assert selected == {id(p) for k, p in trainable.items() if mask[k]}
    assert port.early_stop and port.released == 2


def test_regression_viz_artifacts(tmp_path):
    """The port's CSV rows and plot layout, as fvt_tpu's
    ``tests/test_regression_task.py`` pins them."""
    rng = np.random.default_rng(0)
    per_video = {f'v{i}': {'labels': rng.normal(size=(30,)),
                           'preds': rng.normal(size=(30,))}
                 for i in range(3)}
    perf = metrics.compute_regression_perf(per_video)
    outd = str(tmp_path)
    RV.init_epoch_csv(outd)
    for epoch in (0, 1):
        RV.append_epoch_csv(outd, epoch=epoch, best_epoch=epoch, lr=1e-3,
                            tr_loss=0.5, val_loss=0.6, train_perf=perf,
                            valid_perf=perf)
    RV.append_test_csv(outd, perf)
    with open(os.path.join(outd, 'training_logs.csv')) as f:
        rows = list(csv.reader(f))
    from fvt_tpu.train.regression_viz import CSV_COLUMNS
    assert rows[0] == RV.CSV_COLUMNS == CSV_COLUMNS
    assert len(rows) == 4 and rows[3][0] == 'Test results:'
    assert [float(r[1]) for r in rows[1:3]] == [0, 1]
    d = RV.plot_dir(outd, False, 2)
    assert d.endswith(os.path.join('plot', 'validate', 'epoch_2'))
    assert RV.plot_dir(outd, None, None).endswith(os.path.join('plot',
                                                               'test'))
    d = RV.save_output_vs_label_plots(per_video, perf, outd, epoch=2,
                                      train_mode=False)
    assert sorted(os.listdir(d)) == ['v0.jpg', 'v1.jpg', 'v2.jpg']
