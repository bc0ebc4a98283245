"""Best models in fvt_tpu's msgpack format, and checkpoint / resume.

* The port's writer, fed ``state_from_flax`` of a random flax LFAN's
  variables, gives the bytes of ``flax.serialization.to_bytes`` over the
  trees as ``fvt_tpu``'s ``Trainer.optimize`` saves them, and
  ``load_best_model`` reads them back bit for bit.
* On the CPU at the default dropout 0.1, a run of ``fvt_tpu_torch.main``
  interrupted after an epoch and resumed equals the uninterrupted run
  bit for bit: losses, parameters and buffers, optimizer state, the
  trackers' best values and indices, the best models' bytes, the lr and
  MYWARMUP's state, the early stopper's countdown.
* The checkpointer's own cases, as ``tests/test_checkpoint_resume.py``
  holds ``fvt_tpu``'s: MYWARMUP's plateau state and the stopper's counter
  survive, a step without its sidecar falls back to the older one, two
  steps are kept.
* A tri-modal model's checkpoint and best copy carry the frozen
  backbone's BatchNorm statistics, which a train step moves, bit for bit;
  the writer refuses a backbone key too many or missing.
* ``EarlyStopper`` against ``fvt_tpu``'s on a table of sequences.
"""
import os
import pickle
from os.path import join

import numpy as np
import pytest
import torch

from synth_store import make_meld_store

MODS = ('vggish', 'bert')
TCN = {'vggish': [8, 8, 4, 4], 'bert': [8, 8, 4, 4]}
VIDEO_MODS = ('video',) + MODS
VIDEO_TCN = {**TCN, 'video': [8, 8, 4, 4]}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made these small CPU runs tens of
    times slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ writer
def test_writer_gives_flax_to_bytes_and_reads_back(tmp_path):
    import jax
    from flax import serialization
    from fvt_tpu.models.models import LFAN as FlaxLFAN
    from test_torch_config_store import flax_variables
    from fvt_tpu_torch.models.checkpoint import (load_best_model,
                                                 save_best_model)
    from fvt_tpu_torch.models.from_jax import state_from_flax
    from fvt_tpu_torch.models.models import LFAN

    tcn = {'vggish': [16, 16, 8, 8], 'bert': [24, 24, 16, 16]}
    enc = {m: c[-1] for m, c in tcn.items()}
    x = {'vggish': np.zeros((1, 8, 128), np.float32),
         'bert': np.zeros((1, 8, 768), np.float32)}
    params, stats = flax_variables(
        FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=tcn,
                 encoder_dim=enc), x, 1)
    # fvt_tpu's Trainer.optimize: to_bytes over jax.tree.map'd trees
    want = serialization.to_bytes(
        {'params': jax.tree.map(np.asarray, params),
         'batch_stats': jax.tree.map(np.asarray, stats)})

    state = state_from_flax(params, stats, MODS)
    path = str(tmp_path / 'model.msgpack')
    save_best_model(state, path, MODS)
    with open(path, 'rb') as f:
        assert f.read() == want

    model = LFAN(MODS, 7, tcn_channel=tcn, encoder_dim=enc,
                 generator=torch.Generator().manual_seed(5))
    save_best_model(model, str(tmp_path / 'fresh.msgpack'), MODS)
    load_best_model(model, path, MODS)
    for k, v in model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, state[k]), k


def test_writer_refuses_what_fvt_tpus_tree_lacks(tmp_path):
    from fvt_tpu_torch.models.checkpoint import save_best_model
    from fvt_tpu_torch.models.models import LFAN

    model = LFAN(MODS, 7, tcn_channel=TCN,
                 encoder_dim={m: 4 for m in MODS})
    state = dict(model.state_dict())
    state['regressor.extra'] = torch.zeros(1)
    with pytest.raises(KeyError, match='regressor.extra'):
        save_best_model(state, str(tmp_path / 'a.msgpack'), MODS)
    # a video model's backbone goes to spatial_video/backbone, every key
    # of it: one too many or one missing raises, naming it
    video = LFAN(VIDEO_MODS, 7, tcn_channel=VIDEO_TCN,
                 encoder_dim={m: 4 for m in VIDEO_MODS})
    state = {**video.state_dict(),
             'spatial.visual.backbone.extra': torch.zeros(1)}
    with pytest.raises(KeyError, match='backbone.extra'):
        save_best_model(state, str(tmp_path / 'b.msgpack'), VIDEO_MODS)
    state = dict(video.state_dict())
    del state['spatial.visual.backbone.output_layer.4.running_var']
    with pytest.raises(KeyError, match='output_layer.4.running_var'):
        save_best_model(state, str(tmp_path / 'c.msgpack'), VIDEO_MODS)


# ------------------------------------------------------------------ resume
@pytest.fixture(scope='module')
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('resume_store'))
    return make_meld_store(root, n_train=8, n_val=4, n_test=4, min_len=6,
                           max_len=20, label_noise=0.3)


def _argv(store, outd, epochs, extra, resume=False):
    return ['--dataset_name', 'MELD',
            '--dataset_path', store['dataset_path'],
            '--folds_dir', store['folds_dir'],
            '--modality', 'vggish+bert+EXPR_continuous_label',
            '--model_name', 'LFAN',
            '--num_epochs', str(epochs),
            '--train_batch_size', '4',
            '--num_workers', '1',
            '--window_length', '12',
            '--hop_length', '8',
            '--eval_bucket_quantum', '12',
            '--outd', outd,
            '--checkpoint_every', '1',
            '--resume', 'true' if resume else 'false', *extra]


def _run(argv):
    from fvt_tpu_torch.main import main
    return main(argv, device='cpu').trainer


MYWARMUP = ('--opt__name_lr_scheduler', 'MYWARMUP', '--opt__mode', 'MAX',
            '--min_num_epochs', '0', '--opt__patience', '0',
            '--opt__factor', '0.5', '--early_stopping', '5')


@pytest.mark.parametrize('extra,first', [((), 1), (MYWARMUP, 1)],
                         ids=['mystep', 'mywarmup'])
def test_resume_equals_the_uninterrupted_run_bit_for_bit(store, tmp_path,
                                                          extra, first):
    epochs = 3
    whole = _run(_argv(store, str(tmp_path / 'whole'), epochs, extra))
    outd = str(tmp_path / 'resumed')
    _run(_argv(store, outd, first, extra))
    os.remove(join(outd, 'passed.txt'))
    resumed = _run(_argv(store, outd, epochs, extra, resume=True))

    with open(join(outd, 'log.txt')) as f:
        log = f.read()
    assert f'restored checkpoint from epoch {first - 1}' in log
    assert f'Train epoch (0/{epochs})' not in log
    assert f'Train epoch ({epochs - 1}/{epochs})' in log

    assert resumed.loss_tracker == whole.loss_tracker
    assert len(whole.loss_tracker) == epochs
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    got, want = (t.optimizer.state_dict() for t in (resumed, whole))
    assert got['param_groups'] == want['param_groups']
    assert set(got['state']) == set(want['state'])
    for i, s in want['state'].items():
        for name, t in s.items():
            assert torch.equal(got['state'][i][name], t), (i, name)
    assert resumed.train_step.step == whole.train_step.step
    for case, t in whole.valid_tracker.items():
        r = resumed.valid_tracker[case]
        assert (r.best_value, r.best_value_idx, r.cnt) == \
            (t.best_value, t.best_value_idx, t.cnt), case
        with open(join(outd, 'best-models', str(case),
                       'model.msgpack'), 'rb') as f:
            blob = f.read()
        with open(join(tmp_path / 'whole', 'best-models', str(case),
                       'model.msgpack'), 'rb') as f:
            assert blob == f.read(), case
    assert resumed.scheduler.state_dict() == whole.scheduler.state_dict()
    assert resumed.stopper.counter == whole.stopper.counter
    if extra:
        # the plateau decayed the lr, and the countdown moved
        assert whole.scheduler.current_lr < whole.scheduler.base_lr
        assert whole.stopper.counter < whole.stopper.budget
    assert sorted(os.listdir(join(outd, 'checkpoints'))) == sorted(
        f'{kind}_{e}.{ext}' for e in (epochs - 2, epochs - 1)
        for kind, ext in (('meta', 'pkl'), ('state', 'pt')))


# ------------------------------------------------------------ checkpointer
def _trainer(tmp_path, **config):
    from fvt_tpu_torch.config.defaults import get_config
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.train.trainer import Trainer

    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim={m: 4 for m in MODS},
                 generator=torch.Generator().manual_seed(0))
    cfg = {**get_config('MELD'), 'outd': str(tmp_path), **config}
    return Trainer(model, cfg, 'cpu')


def _one_step(trainer):
    rng = np.random.default_rng(0)
    trainer.train_one_epoch([{
        'vggish': rng.normal(size=(2, 6, 128)).astype(np.float32),
        'bert': rng.normal(size=(2, 6, 768)).astype(np.float32),
        'EXPR_continuous_label': rng.integers(0, 7, (2, 6))}], 0)


def test_mywarmup_state_and_stopper_counter_survive_a_resume(tmp_path):
    from fvt_tpu_torch.train.checkpoint import Checkpointer
    from fvt_tpu_torch.train.metrics import build_trackers
    from fvt_tpu_torch.train.optim import MyWarmupSchedule

    sched = MyWarmupSchedule(0.01, patience=0, factor=0.5,
                             num_warmup_epoch=1)
    sched.step(0, metric=1.0)
    sched.step(1, metric=2.0)
    sched.step(2, metric=2.0)
    assert sched.current_lr < 0.01
    trainer = _trainer(tmp_path)
    _one_step(trainer)
    trackers = build_trackers('MELD', use_other_class=False)
    best = {k: trainer.best_copy() for k in trackers}
    Checkpointer(str(tmp_path)).save(2, trainer, trackers, best,
                                     [1.0, 2.0, 2.0], scheduler=sched,
                                     stopper_counter=2)

    fresh = MyWarmupSchedule(0.01, patience=0, factor=0.5,
                             num_warmup_epoch=1)
    other = _trainer(tmp_path / 'other')
    ck = Checkpointer(str(tmp_path))
    epoch, got_trackers, got_best, losses = ck.restore(other, fresh)
    assert (epoch, losses) == (2, [1.0, 2.0, 2.0])
    assert fresh.state_dict() == sched.state_dict()
    assert fresh.lr(3) == sched.current_lr
    assert ck.restored_stopper_counter == 2
    assert list(got_trackers) == list(trackers)
    for k in best:
        for n, t in best[k].items():
            assert torch.equal(got_best[k][n], t), n
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert other.train_step.step == trainer.train_step.step == 1
    mom = trainer.optimizer.state_dict()['state']
    assert mom and all(
        torch.equal(other.optimizer.state_dict()['state'][i]
                    ['momentum_buffer'], s['momentum_buffer'])
        for i, s in mom.items())


def test_checkpoint_restores_the_backbones_batchnorm_buffers(tmp_path):
    """A tri-modal step moves the frozen backbone's 54 BatchNorms'
    running statistics; a checkpoint carries them, and the best copy
    holds them, bit for bit."""
    from fvt_tpu_torch.config.defaults import get_config
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.train.checkpoint import Checkpointer
    from fvt_tpu_torch.train.metrics import build_trackers
    from fvt_tpu_torch.train.trainer import Trainer

    def trainer(seed, outd):
        model = LFAN(VIDEO_MODS, 7, tcn_channel=VIDEO_TCN,
                     encoder_dim={m: 4 for m in VIDEO_MODS},
                     generator=torch.Generator().manual_seed(seed))
        return Trainer(model, {**get_config('MELD'), 'outd': str(outd)},
                       'cpu')

    def buffers(t):
        return {k: v.clone() for k, v in t.model.named_buffers()
                if k.startswith('spatial.')}

    rng = np.random.default_rng(1)
    live = trainer(0, tmp_path)
    start = buffers(live)
    assert len(start) == 3 * 54
    live.train_one_epoch([{
        'video': rng.integers(0, 256, (1, 4, 48, 48, 3), dtype=np.uint8),
        'vggish': rng.normal(size=(1, 4, 128)).astype(np.float32),
        'bert': rng.normal(size=(1, 4, 768)).astype(np.float32),
        'EXPR_continuous_label': rng.integers(0, 7, (1, 4))}], 0)
    moved = buffers(live)
    for k, v in moved.items():
        assert not torch.equal(v, start[k]), k
    trackers = build_trackers('MELD', use_other_class=False)
    best = {k: live.best_copy() for k in trackers}
    for copy in best.values():
        assert all(torch.equal(copy[k], v) for k, v in moved.items())
        assert not any(k in copy for k, _ in
                       live.model.named_parameters() if
                       k.startswith('spatial.'))
    Checkpointer(str(tmp_path)).save(0, live, trackers, best, [1.0])

    other = trainer(1, tmp_path / 'other')
    _, _, got_best, _ = Checkpointer(str(tmp_path)).restore(other)
    for k, v in buffers(other).items():
        assert torch.equal(v, moved[k]), k
    for k in best:
        for n, t in best[k].items():
            assert torch.equal(got_best[k][n], t), n


def test_restore_falls_back_when_a_sidecar_is_missing(tmp_path):
    from fvt_tpu_torch.train.checkpoint import Checkpointer
    from fvt_tpu_torch.train.metrics import build_trackers

    trainer = _trainer(tmp_path)
    trackers = build_trackers('MELD', use_other_class=False)
    ck = Checkpointer(str(tmp_path), every=1)
    ck.save(0, trainer, trackers, {}, [2.0], stopper_counter=5)
    ck.save(1, trainer, trackers, {}, [2.0, 1.5], stopper_counter=4)
    os.remove(join(ck.dir, 'meta_1.pkl'))  # died between the two writes
    epoch, _, _, losses = ck.restore(trainer)
    assert (epoch, losses) == (0, [2.0])
    assert ck.restored_stopper_counter == 5
    os.remove(join(ck.dir, 'meta_0.pkl'))
    assert ck.restore(trainer) is None


def test_two_checkpoints_are_kept(tmp_path):
    from fvt_tpu_torch.train.checkpoint import Checkpointer
    from fvt_tpu_torch.train.metrics import build_trackers

    trainer = _trainer(tmp_path)
    trackers = build_trackers('MELD', use_other_class=False)
    ck = Checkpointer(str(tmp_path), every=2)
    assert [ck.should_save(e) for e in range(4)] == [False, True, False,
                                                     True]
    for e in range(4):
        ck.save(e, trainer, trackers, {}, [1.0] * (e + 1))
    assert ck.all_steps() == [2, 3] and ck.latest_epoch() == 3
    assert sorted(os.listdir(ck.dir)) == ['meta_2.pkl', 'meta_3.pkl',
                                          'state_2.pt', 'state_3.pt']
    state = torch.load(join(ck.dir, 'state_3.pt'), weights_only=True)
    assert set(state) == {'model', 'optimizer', 'step'}
    with open(join(ck.dir, 'meta_3.pkl'), 'rb') as f:
        assert pickle.load(f)['epoch'] == 3


# ----------------------------------------------------------- early stopping
SEQUENCES = [
    (3, 2, [True, False, False, False, False, False]),
    (3, 0, [False, False, True, False, False, False, False]),
    (2, 1, [False, True, False, False]),
    (1, 0, [False, False]),
    (0, 0, [False] * 5),
    (-1, 2, [False] * 5),
    (4, 3, [True, True, False, True, False, False, False, False, False]),
]


@pytest.mark.parametrize('budget,min_epochs,improved', SEQUENCES)
def test_early_stopper_is_fvt_tpus(budget, min_epochs, improved):
    from fvt_tpu.train.trainer import EarlyStopper as JaxStopper
    from fvt_tpu_torch.train.trainer import EarlyStopper

    got, want = EarlyStopper(budget, min_epochs), JaxStopper(budget,
                                                             min_epochs)
    for epoch, imp in enumerate(improved):
        assert got.should_stop(epoch, imp) == want.should_stop(epoch, imp)
        assert got.counter == want.counter
