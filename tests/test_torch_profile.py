"""``--profile_epochs N`` of the port's trainer (``fvt_tpu``'s
``jax.profiler`` trace of the first epochs, ``train/trainer.py:186-195``)
on the CPU: ``fvt_tpu_torch.main`` with ``--profile_epochs 1`` writes a
``torch.profiler`` Chrome trace of epoch 0, and of no other epoch, under
``<outd>/profile``, and trains to the same losses as without it; the trace
is closed and written when the finite-loss guard raises inside the
epoch.
"""
import json
import math
import os
from os.path import join

import numpy as np
import pytest
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.config.defaults import get_config, to_namespace
from fvt_tpu_torch.main import main
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.tools.synth_store import make_cexpr_store
from fvt_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(store, outd, extra=()):
    return main(['--dataset_name', 'C-EXPR-DB',
                 '--dataset_path', store['dataset_path'],
                 '--folds_dir', store['folds_dir'],
                 '--modality', 'vggish+bert+EXPR_continuous_label',
                 '--num_epochs', '2', '--train_batch_size', '2',
                 '--num_workers', '1', '--window_length', '4',
                 '--hop_length', '2', '--eval_bucket_quantum', '4',
                 '--outd', outd, *extra], device='cpu')


def test_profile_epochs_traces_the_first_epoch(tmp_path):
    store = make_cexpr_store(str(tmp_path / 'store'), [6, 7, 5],
                             ds='C-EXPR-DB', val_lengths=[3, 4], seed=2)
    plain = _train(store, str(tmp_path / 'plain'))
    outd = str(tmp_path / 'traced')
    traced = _train(store, outd, ('--profile_epochs', '1'))
    assert os.listdir(join(outd, 'profile')) == ['epoch0.pt.trace.json']
    with open(join(outd, 'profile', 'epoch0.pt.trace.json')) as f:
        events = json.load(f)['traceEvents']
    assert any('aten::' in e.get('name', '') for e in events)
    assert not os.path.exists(join(str(tmp_path / 'plain'), 'profile'))
    assert traced.trainer.loss_tracker == plain.trainer.loss_tracker
    assert len(traced.trainer.loss_tracker) == 2


def test_the_trace_closes_when_the_loss_guard_raises(tmp_path):
    cfg = get_config(constants.MELD)
    cfg.update(modality='vggish+bert+EXPR_continuous_label', window_length=4,
               nan_guard=True, profile_epochs=1, outd=str(tmp_path))
    trainer = Trainer(init_model(to_namespace(cfg)), cfg, 'cpu')
    rng = np.random.default_rng(0)
    batch = {'vggish': rng.normal(size=(2, 4, 128)).astype(np.float32),
             'bert': rng.normal(size=(2, 4, 768)).astype(np.float32),
             constants.EXPR: np.zeros((2, 4), np.int64)}
    batch['bert'][0, 0, 0] = math.nan
    with pytest.raises(FloatingPointError, match='non-finite loss'):
        trainer.train_one_epoch([batch], 0)
    path = join(str(tmp_path), 'profile', 'epoch0.pt.trace.json')
    with open(path) as f:
        assert json.load(f)['traceEvents']
    # no profiler is left running: the next epoch is not traced
    trainer.config['nan_guard'] = False
    trainer.train_one_epoch([batch], 1)
    assert os.listdir(join(str(tmp_path), 'profile')) == [
        'epoch0.pt.trace.json']
