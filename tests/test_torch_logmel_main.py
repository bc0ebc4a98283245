"""The ``logmel`` modality through the port's store, best models and CLIs,
on the CPU.

* ``tools/synth_store.py --logmel`` writes ``logmel.npy`` as float16
  (T, 96, 64) beside vggish and bert; the port's ``ExampleBuilder`` gives
  fvt_tpu's arrays for ``logmel+bert`` (float32, not normalised; bert
  normalised with the fold's statistics), with and without the native
  gather, which takes the float16 rows of 6144 elements;
* a best model with ``spatial_audio`` (fvt_tpu's LFAN with its VGGish,
  filled with numpy by leaf name) is written by ``save_best_model`` in the
  bytes of ``flax.serialization.to_bytes`` and reads back bit for bit:
  ``fc0``'s kernel (201 MB) is under flax's chunk size, so nothing is
  chunked;
* ``fvt_tpu_torch.main`` trains a full-width ``logmel+bert`` LFAN (the
  VGGish at its one width) for an epoch on a tiny C-EXPR-DB store and
  writes fvt_tpu's run directory; ``inference_challenge`` reads its best
  model back and gives the test pass's logits.
"""
import os
import pickle
from os.path import join
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from fvt_tpu_torch import constants

MODS = ('logmel', 'bert')


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
def store(tmp_path_factory):
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    root = tmp_path_factory.mktemp('logmel')
    return make_cexpr_store(str(root / 'store'), [6, 5], ds='C-EXPR-DB',
                            val_lengths=[3, 7], seed=3, logmel=True)


def _lists(store):
    from fvt_tpu.experiment import Experiment as JaxExperiment
    from fvt_tpu_torch.data.arranger import DataArranger

    args = SimpleNamespace(dataset_name=constants.C_EXPR_DB,
                           use_other_class=False, train_p=100.0,
                           valid_p=100.0, test_p=100.0, seed=0)
    info = JaxExperiment(SimpleNamespace(
        dataset_name=constants.C_EXPR_DB, dataset_path=store['dataset_path'],
        fold_to_run=0, folds_dir=store['folds_dir'],
        modality='logmel')).load_dataset_info()
    arranger = DataArranger(args, info, store['dataset_path'], 0,
                            store['folds_dir'])
    mean_std = arranger.calculate_mean_std(
        arranger.generate_partitioned_trial_list(4, 2, windowing=False))
    return arranger.generate_partitioned_trial_list(4, 2), mean_std


@pytest.mark.parametrize('use_native', [True, False])
def test_logmel_examples_are_fvt_tpus(store, use_native):
    from fvt_tpu.data import native_store as jax_native
    from fvt_tpu.data.dataset import ExampleBuilder as JaxBuilder
    from fvt_tpu_torch.data import native_store
    from fvt_tpu_torch.data.dataset import ExampleBuilder

    assert jax_native.ensure_built() and native_store.ensure_built()
    tdir = join(store['dataset_path'], 'features', 'compacted_48', 'train',
                'vid0')
    disk = np.load(join(tdir, 'logmel.npy'))
    assert disk.dtype == np.float16 and disk.shape == (6, 96, 64)
    assert os.path.isfile(join(tdir, 'vggish.npy'))
    idx = np.array([5, 0, 2, 2])
    rows = native_store.gather_rows(join(tdir, 'logmel.npy'), idx)
    assert rows is not None and rows.dtype == np.float16
    np.testing.assert_array_equal(rows, disk[idx])

    lists, mean_std = _lists(store)
    kw = dict(modality=['logmel', 'bert', constants.EXPR], window_length=4,
              mean_std=mean_std, use_native=use_native)
    port, ref = ExampleBuilder(**kw), JaxBuilder(**kw)
    items = lists[constants.TRAINSET] + lists[constants.VALIDSET]
    assert len(items) >= 4
    for item in items:
        got, want = port.build(item), ref.build(item)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], k)
        assert got['logmel'].dtype == np.float32
        assert got['logmel'].shape == got['bert'].shape[:1] + (96, 64)
    # logmel is the disk's values widened, not normalised
    item = lists[constants.TRAINSET][0]
    np.testing.assert_array_equal(
        port.build(item)['logmel'],
        np.load(join(item[0], 'logmel.npy'))[item[3]].astype(np.float32))


def test_best_model_with_the_vggish_is_flax_bytes(tmp_path):
    from flax import serialization
    from fvt_tpu.models.models import LFAN as FlaxLFAN
    from fvt_tpu.models.vggish import VGGish as FlaxVGGish
    from fvt_tpu_torch.models.checkpoint import (load_best_model,
                                                 read_flax_variables,
                                                 save_best_model)
    from fvt_tpu_torch.models.from_jax import state_from_flax
    from fvt_tpu_torch.models.models import LFAN
    from test_torch_config_store import flax_variables

    tcn = {'logmel': [8, 4], 'bert': [8, 4]}
    enc = {m: 4 for m in MODS}
    x = {'logmel': np.zeros((1, 2, 96, 64), np.float32),
         'bert': np.zeros((1, 2, 768), np.float32)}
    params, stats = flax_variables(
        FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=tcn,
                 encoder_dim=enc, spatial_audio=FlaxVGGish()), x, 5)
    assert 'spatial_audio' in params and 'spatial_audio' not in stats
    want = serialization.to_bytes(
        {'params': jax.tree.map(np.asarray, params),
         'batch_stats': jax.tree.map(np.asarray, stats)})
    model = LFAN(MODS, 7, tcn_channel=tcn, encoder_dim=enc)
    model.load_state_dict(state_from_flax(params, stats, MODS), strict=True)
    path = str(tmp_path / 'model.msgpack')
    save_best_model(model, path, MODS)
    with open(path, 'rb') as f:
        got = f.read()
    assert len(got) == len(want) > 72e6 * 4
    assert got == want
    got_params, _ = read_flax_variables(path)
    np.testing.assert_array_equal(got_params['spatial_audio']['fc0']['kernel'],
                                  np.asarray(params['spatial_audio']['fc0']
                                             ['kernel']))
    fresh = LFAN(MODS, 7, tcn_channel=tcn, encoder_dim=enc,
                 generator=torch.Generator().manual_seed(9))
    load_best_model(fresh, path, MODS)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def _files(outd):
    return sorted(os.path.relpath(join(d, f), outd)
                  for d, _, names in os.walk(outd) for f in names)


def test_main_then_inference_challenge(store, tmp_path):
    from fvt_tpu_torch.inference_challenge import main as challenge
    from fvt_tpu_torch.main import main

    outd = str(tmp_path / 'run')
    exp = main(['--dataset_name', 'C-EXPR-DB',
                '--dataset_path', store['dataset_path'],
                '--folds_dir', store['folds_dir'],
                '--modality', 'logmel+bert+EXPR_continuous_label',
                '--model_name', 'LFAN', '--num_epochs', '1',
                '--train_batch_size', '2', '--num_workers', '1',
                '--window_length', '4', '--hop_length', '2',
                '--eval_bucket_quantum', '4', '--outd', outd], device='cpu')
    vggish = exp.trainer.model.spatial.audio.backbone
    assert sum(p.numel() for p in vggish.parameters()) == 72_141_184
    assert len(exp.trainer.loss_tracker) == 1
    assert np.isfinite(exp.trainer.loss_tracker).all()
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
    with open(join(evald, 'pred-per-frame-eval-test.pkl'), 'rb') as f:
        got = pickle.load(f)
    with open(join(outd, 'pred-per-frame-test-None-perf.pkl'), 'rb') as f:
        want = pickle.load(f)
    assert list(got) == list(want)
    for vid in want:
        assert np.isfinite(got[vid]['logits']).all()
        np.testing.assert_allclose(got[vid]['logits'], want[vid]['logits'],
                                   atol=1e-5, rtol=0)
