"""The port's RegressionTrainer (``fvt_tpu_torch/train/regression_trainer
.py``) in lockstep with fvt_tpu's, on the CPU.

The synthetic trials and loaders of ``tests/test_regression_trainer.py``
(per-frame label tanh(mean feature), windows of 8 at hop 4 over trials of
20 frames, batches of 4) drive both trainers from the same weights
(fvt_tpu's init carried over with ``state_from_flax``), at dropout 0,
with the same ``args``.  Held:

* ``fit`` (3 epochs): the per-epoch losses, rmse, pcc and CCC of both
  ``training_logs.csv`` within 1e-5 relative, the same best epoch each
  epoch, the best CCC within 1e-5, and the test pass's loss within 1e-5
  relative, its per-trial predictions and metrics within 1e-4; the same artifact names (the port writes its resume state
  in ``checkpoint.pt`` beside the pickle sidecar ``checkpoint.pkl``), and
  ``predict``'s per-trial txts;
* the ParamControl release: the same tensors frozen through the first
  epoch and released at the milestone, the same stage, the weights after
  within 1e-4; the stage through a resume;
* within the port: a run resumed from its checkpoint ends bit for bit
  like the uninterrupted one; the epoch loss is the batches' mean losses
  over the number of sequences; the early-stopping countdown; frames no
  window covers raise.
"""
import csv
import functools
import os
from os.path import join
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from fvt_tpu import constants as jax_constants
from fvt_tpu.config.defaults import get_config as jax_get_config
from fvt_tpu.models.models import LFAN as FlaxLFAN
from fvt_tpu.train.param_control import ParamControl as JaxParamControl
from fvt_tpu.train.regression_trainer import \
    RegressionTrainer as JaxRegressionTrainer
from fvt_tpu_torch.config.defaults import get_config
from fvt_tpu_torch.models.from_jax import state_from_flax
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.train.param_control import ParamControl, flax_path
from fvt_tpu_torch.train.regression_trainer import RegressionTrainer
from test_regression_trainer import TRIAL_LEN, _loader, _synth_trials

# float32 rounding drifts apart under SGD at lr 0.05, two- to sixfold an
# epoch (measured on the CPU, the test pass's largest prediction apart
# after 0 to 4 epochs: 2.9e-7, 7.6e-6, 1.6e-5, 3.7e-5, 2.2e-4; the
# validation loss 1.6e-5 relative after 6), so the fit runs 3 epochs,
# where every check holds with a margin
EPOCHS = 3
RTOL = 1e-5
PRED_ATOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made small CPU runs tens of times
    slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(outd, jax_side=False, **over):
    cfg = dict(jax_get_config(jax_constants.MELD) if jax_side
               else get_config('MELD'))
    cfg.update(num_epochs=EPOCHS, min_num_epochs=1, early_stopping=0,
               seed=0, outd=str(outd), opt__lr=0.05, save_plot=False,
               milestone=(), load_best_at_each_epoch=False,
               opt__honor_lr=True)
    cfg.update(over)
    return SimpleNamespace(**cfg)


def _jax_trainer(outd, param_control=None, **over):
    model = FlaxLFAN(modality=('vggish',), output_dim=1,
                     task=jax_constants.REGRESSION, tcn_dropout=0.0,
                     fusion_dropout=0.0)
    tr = JaxRegressionTrainer(model, _args(outd, True, **over),
                              param_control=param_control)
    tr.init_state(next(_loader(_synth_trials(1)))[0])
    return tr


def _port_trainer(outd, jax_tr, param_control=None, **over):
    """The port's trainer from ``jax_tr``'s initial weights."""
    model = LFAN(('vggish',), 1, task='REGRESSION', tcn_dropout=0.0,
                 fusion_dropout=0.0)
    state = jax.tree.map(np.asarray, (jax_tr.state.params,
                                      jax_tr.state.batch_stats))
    model.load_state_dict(state_from_flax(*state, ('vggish',)), strict=True)
    tr = RegressionTrainer(model, _args(outd, **over),
                           param_control=param_control, device='cpu')
    tr.init_state(next(_loader(_synth_trials(1)))[0])
    return tr


def _csv(outd):
    with open(join(outd, 'training_logs.csv')) as f:
        return list(csv.reader(f))


def _files(outd):
    return sorted(os.path.relpath(join(d, f), outd)
                  for d, _, names in os.walk(outd) for f in names)


@pytest.fixture(scope='module')
def fitted(tmp_path_factory):
    """Both trainers fitted for EPOCHS, then their test and predict
    passes, with ``save_plot``."""
    root = tmp_path_factory.mktemp('reg_lockstep')
    train, valid, test = (_synth_trials(n, seed=s)
                          for n, s in ((6, 0), (3, 1), (3, 2)))
    out = {}
    jax_tr = _jax_trainer(root / 'jax', save_plot=True)
    port_tr = _port_trainer(root / 'port', jax_tr, save_plot=True)
    for name, tr in (('jax', jax_tr), ('port', port_tr)):
        best = tr.fit(lambda epoch: _loader(train), lambda: _loader(valid))
        test_pass = tr.test(lambda: _loader(test))
        written = tr.predict(lambda: _loader(test), 'test')
        out[name] = dict(trainer=tr, best=best, test=test_pass,
                         predict=written, outd=str(root / name))
    return out


def test_fit_is_fvt_tpus(fitted):
    jax_rows, port_rows = (_csv(fitted[k]['outd']) for k in ('jax', 'port'))
    assert port_rows[0] == jax_rows[0]
    assert len(port_rows) == len(jax_rows) == EPOCHS + 2
    cols = jax_rows[0]
    for got, want in zip(port_rows[1:-1], jax_rows[1:-1]):
        assert got[cols.index('epoch')] == want[cols.index('epoch')]
        assert got[cols.index('best_epoch')] == \
            want[cols.index('best_epoch')]
        for c in ('lr', 'tr_loss', 'val_loss', 'tr_ccc', 'val_ccc',
                  'val_rmse', 'val_pcc'):
            np.testing.assert_allclose(float(got[cols.index(c)]),
                                       float(want[cols.index(c)]),
                                       rtol=RTOL, err_msg=c)
    port, ref = fitted['port']['best'], fitted['jax']['best']
    assert port['epoch'] == ref['epoch']
    assert port['ccc'] == pytest.approx(ref['ccc'], rel=RTOL)
    assert port['loss'] == pytest.approx(ref['loss'], rel=RTOL)
    # the test pass runs the best weights
    (p_loss, p_perf, p_rec), (j_loss, j_perf, j_rec) = (
        fitted[k]['test'] for k in ('port', 'jax'))
    assert p_loss == pytest.approx(j_loss, rel=RTOL)
    for k in ('rmse', 'pcc', 'ccc'):
        # of predictions held at PRED_ATOL (measured: pcc 1.0e-5 apart)
        assert p_perf[k] == pytest.approx(j_perf[k], abs=PRED_ATOL), k
    assert list(p_rec) == list(j_rec)
    for trial in j_rec:
        np.testing.assert_array_equal(p_rec[trial]['labels'],
                                      j_rec[trial]['labels'])
        np.testing.assert_allclose(p_rec[trial]['preds'],
                                   j_rec[trial]['preds'], rtol=0,
                                   atol=PRED_ATOL)


def test_artifacts_are_fvt_tpus(fitted):
    jax_files, port_files = (_files(fitted[k]['outd'])
                             for k in ('jax', 'port'))
    assert port_files == sorted(jax_files + ['checkpoint.pt'])
    assert {'model_state_dict.msgpack', 'checkpoint.pkl',
            'training_logs.csv', 'dict/valence/test.pkl',
            'plot/test/t0.jpg', 'predict/test/valence/t2.txt'} \
        <= set(port_files)
    import pickle
    with open(join(fitted['port']['outd'], 'dict', 'valence',
                   'test.pkl'), 'rb') as f:
        rec = pickle.load(f)
    assert set(rec) == {'output', 'continuous_label', 'metrics'}
    assert set(rec['metrics']['t0']) == {'rmse', 'pcc', 'ccc'}
    assert rec['metrics']['overall'] == fitted['port']['test'][1]
    # the best model is fvt_tpu's tree: fvt_tpu reads it
    from flax import serialization
    with open(join(fitted['port']['outd'], 'model_state_dict.msgpack'),
              'rb') as f:
        tree = serialization.msgpack_restore(f.read())
    want = fitted['jax']['trainer'].state
    assert jax.tree.structure(tree['params']) == \
        jax.tree.structure(jax.tree.map(np.asarray, want.params))


def test_predict_writes_fvt_tpus_txts(fitted):
    port, ref = fitted['port']['predict'], fitted['jax']['predict']
    assert list(port) == list(ref)
    d = join(fitted['port']['outd'], 'predict', 'test', 'valence')
    _, _, records = fitted['port']['test']
    for trial in ref:
        np.testing.assert_allclose(port[trial], ref[trial], rtol=0,
                                   atol=PRED_ATOL)
        np.testing.assert_array_equal(port[trial], records[trial]['preds'])
        lines = open(join(d, f'{trial}.txt')).read().splitlines()
        assert lines[0] == 'valence' and len(lines) == 1 + TRIAL_LEN
        np.testing.assert_array_equal([float(x) for x in lines[1:]],
                                      port[trial])


def _control(cls):
    return cls([[r'temporal']], release_count=1,
               base_patterns=[r'fusion', r'regressor', r'bn_'])


def test_param_control_release_is_fvt_tpus(tmp_path):
    """Milestone 1: the 'temporal' group frozen through epoch 0 in both,
    released at epoch 1; the same tensors moved at each probe, the
    weights after 3 epochs within 1e-4, the stage through a resume."""
    train, valid = _synth_trials(2, seed=0), _synth_trials(1, seed=1)
    over = dict(num_epochs=3, milestone=(1,))
    jax_tr = _jax_trainer(tmp_path / 'jax', _control(JaxParamControl),
                          **over)
    port_tr = _port_trainer(tmp_path / 'port', jax_tr,
                            _control(ParamControl), **over)

    def jax_moved(start):
        flat = jax.tree_util.tree_flatten_with_path(jax_tr.state.params)[0]
        return {'/'.join(str(k.key) for k in path)
                for path, leaf in flat
                if not np.array_equal(np.asarray(leaf), start[path])}

    def port_moved(start):
        return {flax_path(k) for k, v in port_tr.model.named_parameters()
                if not torch.equal(v.detach(), start[k])}

    jax_start = {path: np.asarray(leaf) for path, leaf in
                 jax.tree_util.tree_flatten_with_path(
                     jax_tr.state.params)[0]}
    port_start = {k: v.detach().clone()
                  for k, v in port_tr.model.named_parameters()}
    probes = {'jax': [], 'port': []}

    def train_fn(name, moved, start):
        def fn(epoch):
            if epoch == 1:  # epoch 0 trained, the milestone just fired
                probes[name].append(moved(start))
            return _loader(train)
        return fn

    jax_tr.fit(train_fn('jax', jax_moved, jax_start),
               lambda: _loader(valid))
    port_tr.fit(train_fn('port', port_moved, port_start),
                lambda: _loader(valid))
    assert probes['port'] == probes['jax']
    assert probes['port'][0] and not any(
        p.startswith('temporal') for p in probes['port'][0])
    assert port_moved(port_start) == jax_moved(jax_start)
    assert any(p.startswith('temporal') for p in port_moved(port_start))
    assert (port_tr.param_control.released,
            port_tr.param_control.early_stop) == (1, False)
    want = state_from_flax(*jax.tree.map(
        np.asarray, (jax_tr.state.params, jax_tr.state.batch_stats)),
        ('vggish',))
    for k, v in port_tr.model.state_dict().items():
        if not k.endswith('num_batches_tracked'):  # flax keeps no count
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)

    again = _port_trainer(tmp_path / 'port', jax_tr,
                          _control(ParamControl), **over)
    again.load_checkpoint()
    assert again.param_control.released == 1
    assert {id(p) for g in again.optimizer.param_groups
            for p in g['params']} == {id(p) for p in
                                      again.model.parameters()}
    for k, v in port_tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def _port_only(outd, **over):
    model = LFAN(('vggish',), 1, task='REGRESSION', tcn_dropout=0.1,
                 fusion_dropout=0.1,
                 generator=torch.Generator().manual_seed(0))
    tr = RegressionTrainer(model, _args(outd, **over), device='cpu')
    tr.init_state(next(_loader(_synth_trials(1)))[0])
    return tr


def test_resume_ends_bit_for_bit_like_the_uninterrupted_run(tmp_path):
    """With dropout on (its stream is (seed, epoch, batch)): 4 epochs
    straight, against 2 then a fresh trainer resumed to 4."""
    train, valid = _synth_trials(4, seed=0), _synth_trials(2, seed=1)
    a = _port_only(tmp_path / 'a', num_epochs=4)
    best_a = a.fit(lambda e: _loader(train), lambda: _loader(valid))
    _port_only(tmp_path / 'b', num_epochs=2).fit(
        lambda e: _loader(train), lambda: _loader(valid))
    b = _port_only(tmp_path / 'b', num_epochs=4)
    b.load_checkpoint()
    assert b.start_epoch == 2 and b.fit_finished
    b.fit_finished = False
    best_b = b.fit(lambda e: _loader(train), lambda: _loader(valid))
    assert (best_b['epoch'], best_b['ccc']) == (best_a['epoch'],
                                                best_a['ccc'])
    for part in ('params', 'batch_stats'):
        for k, v in best_a[part].items():
            assert torch.equal(best_b[part][k], v), k
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    assert _csv(tmp_path / 'a')[1:] and [r[1:] for r in _csv(
        tmp_path / 'b')[1:]] == [r[1:] for r in _csv(tmp_path / 'a')[1:]]


def test_epoch_loss_is_sum_of_batch_means_over_sequences(tmp_path):
    from fvt_tpu_torch.train.losses import ccc_loss

    tr = _port_only(tmp_path)
    test = _synth_trials(3, seed=2)
    loss, _, _ = tr.loop(_loader(test), None, train_mode=False)
    expect, n = 0.0, 0
    for X, trials, _, _ in _loader(test):
        out = tr.eval_forward({'vggish': X['vggish']})
        expect += float(ccc_loss(torch.from_numpy(X['VA_continuous_label']),
                                 out[..., 0]))
        n += len(trials)
    assert loss == pytest.approx(expect / n, abs=1e-12)


def test_uncovered_frames_raise(tmp_path):
    tr = _port_only(tmp_path, num_epochs=1)
    trials = _synth_trials(1, seed=0)

    def gappy():
        for X, names, lengths, indices in _loader(trials):
            yield X, names, [TRIAL_LEN + 5] * len(names), indices

    with pytest.raises(ValueError, match='covered by no window'):
        tr.loop(gappy(), None, train_mode=False)


@functools.lru_cache(maxsize=None)
def _script():
    return (0.5, 0.5, 0.4, 0.3) + (0.2,) * 12


def test_early_stopping_counter_semantics(tmp_path):
    """Validation CCC improves at epoch 0 only; early_stopping=2 and
    min_num_epochs=0: the countdown reaches 0 at epoch 2, and epoch 3
    breaks before it runs, as fvt_tpu's test scripts it."""
    tr = _port_only(tmp_path, num_epochs=8, min_num_epochs=0,
                    early_stopping=2)
    script = iter(_script())
    calls = {'train': 0}

    def fake_loop(loader, epoch, train_mode):
        if train_mode:
            calls['train'] += 1
            return 1.0, {'rmse': 1., 'pcc': 0., 'ccc': 0.}, {}
        return 1.0, {'rmse': 1., 'pcc': 0., 'ccc': next(script)}, {}

    tr.loop = fake_loop
    best = tr.fit(lambda epoch: None, lambda: None)
    assert calls['train'] == 3
    assert best['epoch'] == 0 and best['ccc'] == 0.5
