"""Challenge inference of the port against ``fvt_tpu``'s, on the CPU.

* The acceptance test: on a ``C-EXPR-DB-CHALLENGE`` store of
  ``tests/synth_store.py`` (4 videos of 6-58 frames, window 16, hop 8,
  bucket quantum 16, so both the bucketed and the window path run) and a
  run directory made by hand (``config.yml`` through PyYAML, a random
  full-width ``vggish+bert`` flax LFAN saved with ``serialization.to_bytes`` as
  ``fvt_tpu`` saves a best model), ``fvt_tpu.inference_challenge.main``
  and the port's ``main(device='cpu')`` write the same ``prediction.pkl``
  (keys in order, labels equal, logits within 1e-4) and the same perf
  pickle; again with ``h2d_bf16_features`` and with
  ``eval_device_windows`` off.
* Windows run ``eval_window_batch`` at a time give the logits of one
  forward over all of them.
* A tri-modal run of the port's CLI (``video`` from the store's 48^2
  crops, cropped to 40^2 on the host, through the IR-50) against the
  port's own offline stitch of the plain-version forward.
"""
import os
import shutil
import sys
from os.path import join

import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fvt_tpu_torch import constants  # noqa: E402
from fvt_tpu_torch.config import flat_yaml  # noqa: E402
from fvt_tpu_torch.config.defaults import (get_config,  # noqa: E402
                                           to_namespace)
from fvt_tpu_torch.data import windowing as W  # noqa: E402
from fvt_tpu_torch.models.registry import init_model  # noqa: E402
from fvt_tpu_torch.serve import lfan_serving_forward  # noqa: E402
from fvt_tpu_torch.utils.io import load_pickle  # noqa: E402

DS = constants.C_EXPR_DB_CHALLENGE
CASE = constants.FRM_AVG_LOGITS
WINDOW, HOP, QUANTUM = 16, 8, 16
LOGITS_ATOL = 1e-4


def _config(outd, folds_dir, modality='vggish+bert', **kw):
    cfg = get_config(constants.MELD)
    cfg.update(modality=f'{modality}+{constants.EXPR}', window_length=WINDOW,
               hop_length=HOP, eval_bucket_quantum=QUANTUM, outd=outd,
               folds_dir=folds_dir, **kw)
    return cfg


def _argv(run, store, outd):
    return ['--mode', 'EVALUATION', '--fd_exp', run, '--target_ds_name', DS,
            '--dataset_path', store['dataset_path'], '--folds_dir',
            store['folds_dir'], '--case_best_model', CASE, '--outd', outd]


def _pred(outd):
    return load_pickle(join(outd, f'pred-{DS}', 'prediction.pkl'))


def flax_variables(model, x, seed: int):
    """An ``fvt_tpu`` flax model's (params, batch_stats) in its own tree
    layout (``jax.eval_shape`` of its init, no compile), the values drawn
    with numpy by leaf name: kernels scaled by their fan-in, scales and
    variances about 1, biases and means about 0."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ('var', 'scale', 'g'):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ('kernel', 'v'):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda k: model.init(k, x, train=False),
                            jax.random.key(0))
    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return variables['params'], variables['batch_stats']


@pytest.fixture(scope='module')
def challenge(tmp_path_factory):
    """The store's arrays and a flax model.msgpack, made once."""
    from flax import serialization
    from synth_store import make_cexpr_store
    from fvt_tpu.config.defaults import to_namespace as jax_namespace
    from fvt_tpu.models.registry import init_model as jax_init_model

    root = tmp_path_factory.mktemp('challenge')
    store = make_cexpr_store(str(root / 'store'), ds=DS, n_train=4,
                             min_len=6, max_len=70, seed=0)
    lengths = load_pickle(join(store['dataset_path'], 'features',
                               f'dataset_info_{DS}_train.pkl'))['length']
    assert min(lengths) <= WINDOW < max(lengths), lengths  # both paths

    cfg = _config('', join(str(root), 'folds', constants.MELD))
    model = jax_init_model(jax_namespace(cfg))
    x = {m: np.zeros((1, WINDOW, d), np.float32)
         for m, d in (('vggish', 128), ('bert', 768))}
    params, stats = flax_variables(model, x, 1)
    blob = serialization.to_bytes({'params': params, 'batch_stats': stats})
    return root, store, blob


@pytest.mark.parametrize('variant', [
    {}, {'h2d_bf16_features': True}, {'eval_device_windows': False}],
    ids=['default', 'h2d_bf16_features', 'host_windows'])
def test_prediction_matches_fvt_tpu(challenge, tmp_path, variant):
    from fvt_tpu.inference_challenge import main as jax_main
    from fvt_tpu_torch.inference_challenge import main

    root, store, blob = challenge
    run = tmp_path / 'run'
    best = run / 'best-models' / CASE
    os.makedirs(best)
    with open(run / 'config.yml', 'w') as f:
        yaml.dump(_config(str(run), join(str(root), 'folds', constants.MELD),
                          **variant), f)
    (best / 'model.msgpack').write_bytes(blob)
    outs = {}
    for name, fn, kw in (('fvt_tpu', jax_main, {}),
                         ('port', main, {'device': 'cpu'})):
        # a store each: each run computes the fold's mean/std itself
        mine = dict(store, dataset_path=str(tmp_path / f'store-{name}'))
        shutil.copytree(store['dataset_path'], mine['dataset_path'])
        outs[name] = str(tmp_path / f'out-{name}')
        fn(_argv(str(run), mine, outs[name]), **kw)

    want, got = _pred(outs['fvt_tpu']), _pred(outs['port'])
    assert list(got) == list(want)
    for vid in want:
        np.testing.assert_array_equal(got[vid]['labels'],
                                      want[vid]['labels'])
        assert got[vid]['logits'].dtype == np.float32
        np.testing.assert_allclose(got[vid]['logits'], want[vid]['logits'],
                                   rtol=0, atol=LOGITS_ATOL)
    name = f'eval-{constants.TESTSET}-perf'
    perf = {k: load_pickle(join(outs[k], f'{name}.pkl')) for k in outs}
    np.testing.assert_equal(perf['port'], perf['fvt_tpu'])
    for k in outs:
        with open(join(outs[k], f'{name}.txt')) as f:
            outs[k] = f.read()
    assert outs['port'] == outs['fvt_tpu']


def _tiny_trainer(**cfg):
    from fvt_tpu_torch.train.trainer import Trainer

    config = _config('', '', **cfg)
    model = init_model(to_namespace(config))
    return Trainer(model, config, 'cpu'), config


class _Loader:
    """An EvalLoader's interface over ready batches."""

    def __init__(self, videos):
        self.videos = videos
        self.work_list = [[None, trial, len(v['bert']), None]
                          for trial, v in videos.items()]

    def batches(self, batch_videos, windowed_threshold, center_crop):
        for trial, v in self.videos.items():
            n = len(v['bert'])
            yield ({k: a[None] for k, a in v.items()}, [trial], [n], n)


def test_window_chunks_give_one_forwards_logits():
    rng = np.random.default_rng(3)
    videos = {f'v{n}': {'vggish': rng.normal(size=(n, 128)).astype(np.float32),
                        'bert': rng.normal(size=(n, 768)).astype(np.float32),
                        constants.EXPR: np.full((n,), n % 7, np.int64)}
              for n in (41, 70)}
    trainer, _ = _tiny_trainer(eval_window_batch=3)
    _, chunked = trainer.inference(_Loader(videos))
    for trial, v in videos.items():
        n = len(v['bert'])
        mat = W.window_index_matrix(n, WINDOW, HOP)
        assert len(mat) > 3  # more windows than a chunk
        out = trainer.forward({k: torch.from_numpy(a[mat])
                               for k, a in v.items() if k != constants.EXPR})
        want = W.stitch_windows_np(out.numpy(), mat, n)
        np.testing.assert_allclose(chunked[trial]['logits'], want,
                                   rtol=0, atol=1e-6)


def test_tri_modal_cli_against_the_offline_plain_stitch(tmp_path):
    from fvt_tpu_torch.inference_challenge import main
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    # a window of 8: 24 frames through the IR-50 on the CPU, not 48
    window, hop = 8, 4
    store = make_cexpr_store(str(tmp_path / 'store'), [5, 12], seed=0)
    run = tmp_path / 'run'
    best = run / 'best-models' / CASE
    os.makedirs(best)
    cfg = _config(str(run), join(str(tmp_path), 'folds', constants.MELD),
                  modality='video+vggish+bert')
    cfg.update(window_length=window, hop_length=hop,
               eval_bucket_quantum=window)
    flat_yaml.dump(cfg, str(run / 'config.yml'))
    model = init_model(to_namespace(cfg))  # seed 0
    torch.save(model.state_dict(), best / 'model.pt')
    outd = str(tmp_path / 'out')
    exp = main(_argv(str(run), store, outd), device='cpu')
    got = _pred(outd)
    timing = exp.trainer.last_inference_timing
    assert timing['h2d_bytes'] > 0 and timing['loader_s'] >= 0

    mean_std = load_pickle(join(store['dataset_path'],
                                'mean_std_info_fold-0.pkl'))
    assert list(got) == ['train/vid0', 'train/vid1']
    for trial, rec in got.items():
        tdir = join(store['dataset_path'], 'features', 'compacted_48', trial)
        arrays = {m: np.load(join(tdir, f'{m}.npy'))
                  for m in ('video', 'vggish', 'bert')}
        for m in ('vggish', 'bert'):
            st = mean_std[m]
            arrays[m] = ((arrays[m] - st['mean'].astype(np.float32))
                         / st['std'].astype(np.float32))
        arrays['video'] = arrays['video'][:, 4:44, 4:44]  # the center crop
        n = len(arrays['bert'])
        if n <= window:
            idx = W.pad_short_window_indices(n, window)[None]
        else:
            idx = W.window_index_matrix(n, window, hop)
        out = lfan_serving_forward(
            model, {k: torch.from_numpy(np.ascontiguousarray(a[idx]))
                    for k, a in arrays.items()}, reference=True).numpy()
        want = out[0] if n <= window else W.stitch_windows_np(out, idx, n)
        assert rec['logits'].shape == want.shape == (max(n, window), 7)
        np.testing.assert_allclose(rec['logits'], want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            rec['labels'], np.load(join(tdir, f'{constants.EXPR}.npy'))[
                np.minimum(np.arange(max(n, window)), n - 1)])
