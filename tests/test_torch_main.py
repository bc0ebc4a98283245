"""The training CLI of the port against fvt_tpu's, on the CPU.

``fvt_tpu.main.main`` and ``fvt_tpu_torch.main.main(device='cpu')`` train
the full-width ``vggish+bert`` LFAN for 2 epochs on one small MELD store
of ``tests/synth_store.py`` (window 16, hop 8, batch 4), both from one
``model.pt`` (``--pretrained_torch_ckpt``: a seeded fvt_tpu LFAN through
``fvt_tpu.models.torch_export.lfan_to_torch``; the port drops the dead
keys), both at dropout 0: each package's ``experiment.init_model`` is
patched to build the model so, because the two frameworks' random
streams cannot match.  The JAX run goes once, in a module fixture.

Held: the same run-directory files; epoch losses within 1e-4 relative;
each criterion's best epoch; the test pass's predicted labels equal and
logits within 1e-3, the perf pickles equal where the labels are; the
port's ``model.msgpack`` carrying fvt_tpu's tree from the same run (keys,
shapes, dtypes; values within 1e-4) and loading through
``flax.serialization.from_bytes`` with fvt_tpu's file as its target;
``config.yml`` read by ``yaml.safe_load`` with fvt_tpu's keys; and the
port's ``inference_challenge`` reading its own best model back.
"""
import os
import pickle
from os.path import join

import numpy as np
import pytest
import torch

from synth_store import make_meld_store

MODALITY = ('vggish', 'bert')
EPOCHS = 2
LOSS_RTOL = 1e-4
LOGIT_ATOL = 1e-3
PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made these small CPU runs tens of
    times slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(store, outd, ckpt):
    return ['--dataset_name', 'MELD',
            '--dataset_path', store['dataset_path'],
            '--folds_dir', store['folds_dir'],
            '--modality', 'vggish+bert+EXPR_continuous_label',
            '--model_name', 'LFAN',
            '--num_epochs', str(EPOCHS),
            '--train_batch_size', '4',
            '--num_workers', '1',
            '--window_length', '16',
            '--hop_length', '8',
            '--eval_bucket_quantum', '16',
            '--pretrained_torch_ckpt', ckpt,
            '--outd', outd]


def _files(outd):
    return sorted(os.path.relpath(join(d, f), outd)
                  for d, _, names in os.walk(outd) for f in names)


def _start_weights(path):
    """A model.pt of a seeded full-width fvt_tpu LFAN, in the upstream
    key layout."""
    from test_torch_config_store import flax_variables
    from fvt_tpu.config import model_config as MC
    from fvt_tpu.models.models import LFAN
    from fvt_tpu.models.torch_export import lfan_to_torch

    model = LFAN(modality=MODALITY, output_dim=7,
                 tcn_channel=MC.TCN_CHANNELS)
    x = {m: np.zeros((1, 8, MC.EMBEDDING_DIM[m]), np.float32)
         for m in MODALITY}
    params, stats = flax_variables(model, x, 3)
    sd = lfan_to_torch(params, stats, MODALITY, MC.TCN_CHANNELS,
                       MC.EMBEDDING_DIM)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import fvt_tpu.experiment as jax_experiment
    import fvt_tpu_torch.experiment as port_experiment
    from fvt_tpu.main import main as jax_main
    from fvt_tpu.train.trainer import Trainer as JaxTrainer
    from fvt_tpu_torch.main import main as port_main

    root = tmp_path_factory.mktemp('main')
    store = make_meld_store(str(root / 'store'), n_train=12, n_val=4,
                            n_test=4, min_len=8, max_len=30)
    ckpt = str(root / 'model.pt')
    _start_weights(ckpt)

    jax_init, port_init = (jax_experiment.init_model,
                           port_experiment.init_model)

    def jax_no_dropout(args, **kw):
        return jax_init(args, **kw).clone(tcn_dropout=0.0,
                                          fusion_dropout=0.0)

    def port_no_dropout(args, generator=None):
        model = port_init(args, generator)
        for net in model.temporal.values():
            for blk in net.network:
                blk.dropout = 0.0
        model.fusion.dropout = 0.0
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
    return {'store': store, 'jax': str(root / 'jax'),
            'port': str(root / 'port'), 'jax_run': jax_run,
            'trainer': exp.trainer}


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def _cases(outd):
    return sorted(os.listdir(join(outd, 'best-models')))


def test_same_run_directory(runs):
    assert _files(runs['port']) == _files(runs['jax'])
    assert _cases(runs['port']) == ['FRAMES_AVG_LOGITS', 'FRAMES_AVG_PROBS',
                                    'FRAMES_VOTE']


def test_epoch_losses_and_best_epochs_are_fvt_tpus(runs):
    trainer, jax_run = runs['trainer'], runs['jax_run']
    assert len(trainer.loss_tracker) == EPOCHS
    np.testing.assert_allclose(trainer.loss_tracker, jax_run['losses'],
                               rtol=LOSS_RTOL)
    assert set(trainer.valid_tracker) == set(jax_run['valid'])
    for case, tracker in trainer.valid_tracker.items():
        want = jax_run['valid'][case]
        assert tracker.best_value_idx == want.best_value_idx, case
        assert tracker.best_value == pytest.approx(want.best_value), case
    with open(join(runs['port'], 'log.txt')) as f:
        log = f.read()
    for e in range(EPOCHS):
        assert f'Train epoch ({e}/{EPOCHS}) loss: ' in log


def _same_perf(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_perf(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize('case', ['FRAMES_AVG_LOGITS', 'FRAMES_AVG_PROBS',
                                  'FRAMES_VOTE'])
def test_test_pass_is_fvt_tpus(runs, case):
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
    name = f'test-{case}-perf.pkl'
    _same_perf(_load(join(runs['port'], name)), _load(join(runs['jax'],
                                                           name)))


def test_best_model_is_fvt_tpus_tree(runs):
    from flax import serialization

    for case in _cases(runs['jax']):
        paths = [join(runs[side], 'best-models', case, 'model.msgpack')
                 for side in ('port', 'jax')]
        got, want = (serialization.msgpack_restore(open(p, 'rb').read())
                     for p in paths)
        flat_got = dict(_flat(got))
        flat_want = dict(_flat(want))
        assert list(flat_got) == list(flat_want), case
        for k, w in flat_want.items():
            g = flat_got[k]
            assert (g.shape, g.dtype) == (w.shape, w.dtype), (case, k)
            np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0,
                                       err_msg=f'{case} {k}')
        with open(paths[0], 'rb') as f:
            loaded = serialization.from_bytes(want, f.read())
        for k, g in _flat(loaded):
            np.testing.assert_array_equal(g, flat_got[k])


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', v


def test_config_has_fvt_tpus_keys(runs):
    import yaml

    for rel in ['config.yml'] + [join('best-models', c, 'config.yml')
                                 for c in _cases(runs['jax'])]:
        with open(join(runs['port'], rel)) as f:
            got = yaml.safe_load(f)
        with open(join(runs['jax'], rel)) as f:
            want = yaml.safe_load(f)
        assert set(got) == set(want), rel
        assert got['mode'] == want['mode'] == 'TRAINING'
    with open(join(runs['port'], 'passed.txt')) as f:
        assert f.read() == 'Passed.'


def test_challenge_cli_reads_the_ports_best_model(runs, tmp_path):
    """The port's inference_challenge on its own run directory gives the
    test pass's logits: the written model.msgpack is the model."""
    from fvt_tpu_torch.inference_challenge import main

    store = runs['store']
    case = 'FRAMES_AVG_LOGITS'
    outd = str(tmp_path / 'eval')
    main(['--mode', 'EVALUATION', '--fd_exp', runs['port'],
          '--target_ds_name', 'MELD', '--eval_set', 'test',
          '--case_best_model', case,
          '--dataset_path', store['dataset_path'],
          '--folds_dir', store['folds_dir'], '--outd', outd], device='cpu')
    got = _load(join(outd, 'pred-per-frame-eval-test.pkl'))
    want = _load(join(runs['port'], f'pred-per-frame-test-{case}-perf.pkl'))
    assert list(got) == list(want)
    for vid in want:
        np.testing.assert_allclose(got[vid]['logits'], want[vid]['logits'],
                                   atol=1e-5, rtol=0)


def test_tri_modal_main_writes_the_run_and_reads_its_best_model(tmp_path):
    """``video+vggish+bert`` through the CLI on the CPU: the full-width
    model (the IR-50 in train mode, the TCN widths of ``TCN_CHANNELS``)
    for one epoch over a C-EXPR-DB store of the port's writer (48^2 uint8
    crops, window 4): the run directory ``fvt_tpu.main`` writes, a best
    model that carries ``fvt_tpu``'s ArcFace subtree with the statistics
    the epoch moved, and the port's inference_challenge reading it back
    to the test pass's logits (atol 1e-5)."""
    from fvt_tpu_torch.inference_challenge import main as challenge
    from fvt_tpu_torch.main import main
    from fvt_tpu_torch.models.checkpoint import read_flax_variables
    from fvt_tpu_torch.models.from_jax import visual_backbone_state_from_flax
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    store = make_cexpr_store(str(tmp_path / 'store'), [6, 7, 5],
                             ds='C-EXPR-DB', val_lengths=[3, 4], seed=2)
    outd = str(tmp_path / 'run')
    exp = main(['--dataset_name', 'C-EXPR-DB',
                '--dataset_path', store['dataset_path'],
                '--folds_dir', store['folds_dir'],
                '--modality', 'video+vggish+bert+EXPR_continuous_label',
                '--num_epochs', '1', '--train_batch_size', '2',
                '--num_workers', '1', '--window_length', '4',
                '--hop_length', '2', '--eval_bucket_quantum', '4',
                '--outd', outd], device='cpu')
    assert _files(outd) == sorted(
        ['config.yml', 'log.json', 'log.txt', 'passed.txt',
         'test-None-perf.txt', 'test-None-perf.pkl',
         'pred-per-frame-test-None-perf.pkl',
         'best-models/None/model.msgpack', 'best-models/None/config.yml'])
    assert len(exp.trainer.loss_tracker) == 1
    assert np.isfinite(exp.trainer.loss_tracker).all()

    params, stats = read_flax_variables(
        join(outd, 'best-models', 'None', 'model.msgpack'))
    assert set(params) >= {'spatial_video', 'temporal_video', 'regressor'}
    backbone = visual_backbone_state_from_flax(params['spatial_video'],
                                               stats['spatial_video'])
    live = exp.trainer.model.state_dict()
    for k, v in backbone.items():
        if 'num_batches_tracked' not in k:
            assert torch.equal(v, live[f'spatial.visual.{k}']), k
    init = exp.trainer.model.spatial.visual.backbone.input_layer[1]
    assert int(init.num_batches_tracked) == exp.trainer.train_step.step > 0

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
        np.testing.assert_allclose(got[vid]['logits'], want[vid]['logits'],
                                   atol=1e-5, rtol=0)


def test_main_needs_a_card_unless_the_cpu_is_named(tmp_path):
    from fvt_tpu_torch.main import main

    if torch.cuda.is_available():
        pytest.skip('needs a machine without a CUDA card')
    outd = tmp_path / 'never'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(['--outd', str(outd)])
    assert not outd.exists()
