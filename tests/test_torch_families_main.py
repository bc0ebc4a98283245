"""The training and challenge CLIs of the port on CAN and MT, on the CPU.

* ``fvt_tpu.main`` and ``fvt_tpu_torch.main.main(device='cpu')`` train a
  CAN on ``vggish+bert`` for 2 epochs on one small MELD store of
  ``tests/synth_store.py`` (window 16, hop 8, batch 4), both from one
  upstream-named ``model.pt`` (``--pretrained_torch_ckpt``: a seeded
  fvt_tpu CAN through ``torch_export.can_to_torch``, its dead ``conv_c``
  included; the port drops it), both at dropout 0 (each package's
  ``experiment.init_model`` patched, as ``tests/test_torch_main.py`` does
  for LFAN) and on narrow TCNs (``TCN_SETTINGS`` patched in both
  packages, which their CLIs and checkpoint readers read).  Held: the
  same run-directory files, epoch losses within 1e-4 relative, each
  criterion's best epoch, the test pass's predicted labels equal and
  logits within 1e-3.
* ``main`` then ``inference_challenge`` on MT over a C-EXPR-DB store of
  the port's writer with 48^2 video (the IR-50 in train mode, then in
  eval, one video a forward with its mask): the run directory, and the
  best model read back to the test pass's logits (atol 1e-5).
"""
import os
import pickle
from os.path import join

import numpy as np
import pytest
import torch

from synth_store import make_meld_store

MODALITY = ('vggish', 'bert')
SETTINGS = {'vggish': {'input_dim': 128, 'channel': [16, 8],
                       'kernel_size': 5},
            'bert': {'input_dim': 768, 'channel': [16, 8], 'kernel_size': 3},
            'video': {'input_dim': 512, 'channel': [16, 128],
                      'kernel_size': 5}}
EPOCHS = 2
LOSS_RTOL = 1e-4
LOGIT_ATOL = 1e-3


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made small CPU runs tens of times
    slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def narrow_settings():
    """Both packages' ``TCN_SETTINGS`` narrowed for the module."""
    from fvt_tpu.config import model_config as jax_mc
    from fvt_tpu_torch.config import model_config as port_mc

    with pytest.MonkeyPatch.context() as mp:
        for mc in (jax_mc, port_mc):
            for m, s in SETTINGS.items():
                mp.setitem(mc.TCN_SETTINGS, m, s)
        yield


def _files(outd):
    return sorted(os.path.relpath(join(d, f), outd)
                  for d, _, names in os.walk(outd) for f in names)


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def _argv(store, outd, ckpt):
    return ['--dataset_name', 'MELD',
            '--dataset_path', store['dataset_path'],
            '--folds_dir', store['folds_dir'],
            '--modality', 'vggish+bert+EXPR_continuous_label',
            '--model_name', 'CAN', '--num_epochs', str(EPOCHS),
            '--train_batch_size', '4', '--num_workers', '1',
            '--window_length', '16', '--hop_length', '8',
            '--eval_bucket_quantum', '16',
            '--pretrained_torch_ckpt', ckpt, '--outd', outd]


@pytest.fixture(scope='module')
def runs(tmp_path_factory, narrow_settings):
    import fvt_tpu.experiment as jax_experiment
    import fvt_tpu_torch.experiment as port_experiment
    from fvt_tpu.main import main as jax_main
    from fvt_tpu.models.models import CAN
    from fvt_tpu.models.torch_export import can_to_torch
    from fvt_tpu.train.trainer import Trainer as JaxTrainer
    from fvt_tpu_torch.main import main as port_main
    from test_torch_config_store import flax_variables

    root = tmp_path_factory.mktemp('families_main')
    store = make_meld_store(str(root / 'store'), n_train=8, n_val=3,
                            n_test=3, min_len=8, max_len=30)
    ckpt = str(root / 'model.pt')
    x = {m: np.zeros((1, 8, SETTINGS[m]['input_dim']), np.float32)
         for m in MODALITY}
    params, stats = flax_variables(
        CAN(modality=MODALITY, output_dim=7, tcn_settings=SETTINGS), x, 4)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                can_to_torch(params, stats, MODALITY, SETTINGS).items()},
               ckpt)

    jax_init, port_init = (jax_experiment.init_model,
                           port_experiment.init_model)

    def jax_no_dropout(args, **kw):
        return jax_init(args, **kw).clone(tcn_dropout=0.0)

    def port_no_dropout(args, generator=None):
        model = port_init(args, generator)
        for net in model.temporal.values():
            for blk in net.network:
                blk.dropout = 0.0
        return model

    jax_run = {'losses': []}
    train_one_epoch, optimize = JaxTrainer.train_one_epoch, \
        JaxTrainer.optimize

    def record_epoch(self, loader, epoch):
        loss = train_one_epoch(self, loader, epoch)
        jax_run['losses'].append(loss)
        return loss

    def record_run(self, *a, **kw):
        jax_run['valid'], jax_run['test'] = optimize(self, *a, **kw)
        return jax_run['valid'], jax_run['test']

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_experiment, 'init_model', jax_no_dropout)
        mp.setattr(port_experiment, 'init_model', port_no_dropout)
        mp.setattr(JaxTrainer, 'train_one_epoch', record_epoch)
        mp.setattr(JaxTrainer, 'optimize', record_run)
        jax_main(_argv(store, str(root / 'jax'), ckpt))
        exp = port_main(_argv(store, str(root / 'port'), ckpt),
                        device='cpu')
    return {'jax': str(root / 'jax'), 'port': str(root / 'port'),
            'jax_run': jax_run, 'trainer': exp.trainer}


def test_can_run_directory_and_losses_are_fvt_tpus(runs):
    assert _files(runs['port']) == _files(runs['jax'])
    trainer, jax_run = runs['trainer'], runs['jax_run']
    assert trainer.model.model_name == 'CAN'
    np.testing.assert_allclose(trainer.loss_tracker, jax_run['losses'],
                               rtol=LOSS_RTOL)
    assert set(trainer.valid_tracker) == set(jax_run['valid'])
    for case, tracker in trainer.valid_tracker.items():
        want = jax_run['valid'][case]
        assert tracker.best_value_idx == want.best_value_idx, case
        assert tracker.best_value == pytest.approx(want.best_value), case


@pytest.mark.parametrize('case', ['FRAMES_AVG_LOGITS', 'FRAMES_AVG_PROBS',
                                  'FRAMES_VOTE'])
def test_can_test_pass_is_fvt_tpus(runs, case):
    name = f'pred-per-frame-test-{case}-perf.pkl'
    got, want = _load(join(runs['port'], name)), _load(join(runs['jax'],
                                                            name))
    assert list(got) == list(want)
    for vid in want:
        np.testing.assert_array_equal(got[vid]['labels'],
                                      want[vid]['labels'])
        np.testing.assert_array_equal(got[vid]['logits'].argmax(-1),
                                      want[vid]['logits'].argmax(-1))
        np.testing.assert_allclose(got[vid]['logits'], want[vid]['logits'],
                                   atol=LOGIT_ATOL, rtol=0)


def test_mt_main_then_inference_challenge(tmp_path, narrow_settings):
    from fvt_tpu_torch.inference_challenge import main as challenge
    from fvt_tpu_torch.main import main
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    store = make_cexpr_store(str(tmp_path / 'store'), [6, 5],
                             ds='C-EXPR-DB', val_lengths=[3, 7], seed=3)
    outd = str(tmp_path / 'run')
    exp = main(['--dataset_name', 'C-EXPR-DB',
                '--dataset_path', store['dataset_path'],
                '--folds_dir', store['folds_dir'],
                '--modality', 'video+vggish+EXPR_continuous_label',
                '--model_name', 'MT', '--num_epochs', '1',
                '--train_batch_size', '2', '--num_workers', '1',
                '--window_length', '4', '--hop_length', '2',
                '--eval_bucket_quantum', '4', '--outd', outd], device='cpu')
    assert exp.trainer.model.model_name == 'MT'
    assert _files(outd) == sorted(
        ['config.yml', 'log.json', 'log.txt', 'passed.txt',
         'test-None-perf.txt', 'test-None-perf.pkl',
         'pred-per-frame-test-None-perf.pkl',
         'best-models/None/model.msgpack', 'best-models/None/config.yml'])
    evald = str(tmp_path / 'eval')
    challenge(['--mode', 'EVALUATION', '--fd_exp', outd,
               '--target_ds_name', 'C-EXPR-DB', '--eval_set', 'test',
               '--case_best_model', 'None',
               '--dataset_path', store['dataset_path'],
               '--folds_dir', store['folds_dir'], '--outd', evald],
              device='cpu')
    got = _load(join(evald, 'pred-per-frame-eval-test.pkl'))
    want = _load(join(outd, 'pred-per-frame-test-None-perf.pkl'))
    assert list(got) == list(want)
    for vid in want:
        assert np.isfinite(got[vid]['logits']).all()
        np.testing.assert_allclose(got[vid]['logits'], want[vid]['logits'],
                                   atol=1e-5, rtol=0)
