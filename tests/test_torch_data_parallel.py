"""Data-parallel training of the port on the CPU: two ranks over ``gloo``
(``fvt_tpu_torch.parallel.mesh.spawn``, ``tests/torch_dp_worker.py``)
against one process, from the same store, weights and seed, dropout on.

* ``fvt_tpu_torch.main --data_parallel true`` in both ranks against the
  same CLI without the flag: the full-width ``vggish+bert`` LFAN for 2
  epochs on a MELD store whose batch plan has a ragged batch (one the
  world size does not divide, which runs replicated and is logged): the
  epoch and step losses within LOSS_RTOL, every parameter and statistic
  within PARAM_ATOL, the two ranks bit for bit alike; the run directory's
  files those of one process, written once; then the test split's eval
  pass on the same weights, its long videos' window batches spread over
  the ranks, device-windowed and host-pooled, within LOGIT_ATOL of one
  process's.
* The step cases (the REGRESSION task's CCC, CAN in float64, JMT, a
  ``video`` LFAN) are in ``tests/test_torch_data_parallel_steps.py``.
* ``host_slice`` and ``TrainLoader.epoch_local`` against ``fvt_tpu``'s.

The fp32 tolerances: DP sums the batch's moments and gradients in another
order than one process, ~1e-7 apart after two epochs here; LOSS_RTOL and
PARAM_ATOL leave two orders of magnitude of room, and a mask or moment
taken from the wrong rows moves them by 1e-2 and more.
"""
import os
import pickle
from os.path import join

import numpy as np
import pytest
import torch

from fvt_tpu_torch.parallel import mesh
from fvt_tpu_torch.tools.synth_store import make_meld_store

import torch_dp_worker as worker

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
LOGIT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(store, outd, extra=()):
    return ['--dataset_name', 'MELD',
            '--dataset_path', store['dataset_path'],
            '--folds_dir', store['folds_dir'],
            '--modality', 'vggish+bert+EXPR_continuous_label',
            '--model_name', 'LFAN', '--num_epochs', '2',
            '--train_batch_size', '4', '--num_workers', '1',
            '--window_length', '8', '--hop_length', '4',
            '--eval_bucket_quantum', '8', '--eval_window_batch', '3',
            '--seed', '0', '--outd', outd, *extra]


def _load(out, world=2):
    return [pickle.load(open(f'{out}.{r}', 'rb')) for r in range(world)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dp'))
    # 39 train windows: nine batches of 4, split 2 and 2, and one of 3
    store = make_meld_store(join(root, 'store'), n_train=17, n_val=4,
                            n_test=4, min_len=6, max_len=20, seed=3)
    out = join(root, 'single.pkl')
    os.environ['RANK'] = '0'
    try:
        worker.run_main(_argv(store, join(root, 'single')), out)
    finally:
        del os.environ['RANK']
    single = pickle.load(open(f'{out}.0', 'rb'))
    out = join(root, 'dp.pkl')
    mesh.spawn(worker.run_main, 2,
               _argv(store, join(root, 'dp'), ['--data_parallel', 'true']),
               out)
    return dict(root=root, single=single, dp=_load(out))


def test_dp_losses_and_parameters_equal_one_process(runs):
    single, dp = runs['single'], runs['dp']
    for r in dp:
        np.testing.assert_allclose(r['losses'], single['losses'],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r['step_losses'], single['step_losses'],
                                   rtol=LOSS_RTOL)
    assert single['state'].keys() == dp[0]['state'].keys()
    for k, want in single['state'].items():
        for r in dp:
            np.testing.assert_allclose(r['state'][k].double().numpy(),
                                       want.double().numpy(),
                                       atol=PARAM_ATOL, err_msg=k)
        assert torch.equal(dp[0]['state'][k], dp[1]['state'][k]), k


def test_dp_window_sharded_eval_equals_one_process(runs):
    single, dp = runs['single'], runs['dp']
    for device_windows in (True, False):
        want = single['logits'][device_windows]
        for r in dp:
            got = r['logits'][device_windows]
            assert list(got) == list(want)
            for trial in want:
                np.testing.assert_allclose(got[trial]['logits'],
                                           want[trial]['logits'],
                                           atol=LOGIT_ATOL)
                np.testing.assert_array_equal(got[trial]['labels'],
                                              want[trial]['labels'])
    # the stitch path ran: a test video longer than the window
    assert any(len(v['labels']) > 8 for v in want.values())


def test_dp_only_rank0_writes_and_logs_its_ragged_batches(runs):
    def files(d):
        return sorted(os.path.relpath(join(p, f), d)
                      for p, _, fs in os.walk(d) for f in fs)
    single, dp = join(runs['root'], 'single'), join(runs['root'], 'dp')
    assert files(dp) == files(single)
    with open(join(dp, 'log.txt')) as f:
        log = f.read()
    assert log.count('Starting experiment') == 1
    assert 'data-parallel over 2 ranks (gloo)' in log
    assert 'batches ran replicated (size not divisible by 2 ranks)' in log


def test_host_slice_and_epoch_local_match_fvt_tpu():
    from fvt_tpu.parallel.multihost import host_slice as want
    from fvt_tpu_torch.parallel.multihost import host_slice
    for rows in range(0, 13):
        for count in (1, 2, 3, 4):
            for index in range(count):
                assert host_slice(rows, index, count) == \
                    want(rows, index, count)
    batch = {'x': np.arange(12).reshape(6, 2)}
    world = mesh.World(1, 2, 1, torch.device('cpu'), 'gloo')
    np.testing.assert_array_equal(mesh.shard_batch(batch, world)['x'],
                                  batch['x'][3:])
    odd = {'x': batch['x'][:5]}
    assert mesh.shard_batch(odd, world)['x'] is odd['x']  # replicated

    from fvt_tpu.data.loader import TrainLoader as JaxLoader
    from fvt_tpu_torch.data.loader import TrainLoader

    class Builder:
        window_length = 4

        def build(self, item, pad_to=None):
            return {'x': np.full((4, 2), item[2], np.float32)}

    work = [('p', f't{i}', i, 0) for i in range(11)]
    for kw in ({}, {'bucket_quantum': 2}):
        port = TrainLoader(work, Builder(), batch_size=4, seed=3,
                           num_threads=1, **kw)
        ref = JaxLoader(work, Builder(), batch_size=4, seed=3,
                        num_threads=1, **kw)
        for index in range(2):
            got = list(port.epoch_local(1, divisor=2, process_index=index,
                                        process_count=2))
            exp = list(ref.epoch_local(1, divisor=2, process_index=index,
                                       process_count=2))
            assert [r for _, r in got] == [r for _, r in exp]
            for (a, _), (b, _) in zip(got, exp):
                np.testing.assert_array_equal(a['x'], b['x'])
