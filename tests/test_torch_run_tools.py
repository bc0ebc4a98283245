"""The port's run tools against ``fvt_tpu``'s, on the CPU.

* ``fvt_tpu_torch.tools.synth_store``'s ``make_meld_store`` and drawn
  ``make_cexpr_store`` (the hardness knobs and the k-fold splits
  included) write ``tests/synth_store.py``'s stores file for file: the
  same arrays, pickles that load equal, the same text bytes; a store of
  given lengths keeps its own draws.
* ``validate_store``: the JSON report equal to ``tools/validate_store.py``'s
  ``validate`` on the same stores (clean; a truncated ``.npy``; a stale
  ``video_48.npy``; a fold naming a trial the store lacks; a stale
  mean/std cache), and after ``--repair`` of two copies the same repair
  actions and post-repair report; exit codes 0 clean, 1 on an error.
* ``summarize_runs``: the JSON summary and the rendered table equal to
  ``tools/summarize_runs.py``'s over the same run directories
  (``config.yml`` written by PyYAML, MELD and C-EXPR-DB, folds and seeds,
  an unfinished run).
* ``port_checkpoint``: the msgpack of a ``model.pt`` byte-equal to what
  ``tools/port_checkpoint.py`` writes from it (LFAN, CAN over three
  modalities, MT with its ArcFace), and ``--reverse`` giving that tool's
  upstream state_dict (dead keys included), which loads back into the
  port's model as the state it came from.
"""
import importlib.util
import json
import os
import pickle
import shutil
import types
from os.path import join

import numpy as np
import pytest
import torch
import yaml

import synth_store as jax_synth
from fvt_tpu_torch import constants
from fvt_tpu_torch.config.defaults import get_config
from fvt_tpu_torch.models.from_jax import is_dead_key
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.tools import port_checkpoint, summarize_runs
from fvt_tpu_torch.tools import synth_store, validate_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    """``tools/<name>.py`` of ``fvt_tpu``, loaded under another name."""
    spec = importlib.util.spec_from_file_location(
        f'fvt_tools_{name}', join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(os.path.relpath(join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_store(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        pa, pb = join(a, f), join(b, f)
        if f.endswith('.npy'):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        elif f.endswith('.pkl'):
            with open(pa, 'rb') as fa, open(pb, 'rb') as fb:
                assert pickle.load(fa) == pickle.load(fb), f
        else:
            with open(pa, 'rb') as fa, open(pb, 'rb') as fb:
                assert fa.read() == fb.read(), f


@pytest.mark.parametrize('maker,kw', [
    ('make_meld_store', dict(n_train=5, n_val=2, n_test=2, min_len=4,
                             max_len=9, label_noise=0.3, ambiguity=0.4,
                             with_video=True)),
    ('make_cexpr_store', dict(ds=constants.C_EXPR_DB, n_train=8, n_val=4,
                              min_len=4, max_len=9, seed=300,
                              separation=0.8, label_noise=0.25,
                              ambiguity=0.25, n_folds=3, video_hw=8)),
    ('make_cexpr_store', dict(ds=constants.C_EXPR_DB_CHALLENGE, n_train=3,
                              min_len=6, max_len=12, video_hw=16)),
])
def test_synth_stores_equal_the_test_helpers(tmp_path, maker, kw):
    getattr(jax_synth, maker)(str(tmp_path / 'jax'), **kw)
    getattr(synth_store, maker)(str(tmp_path / 'port'), **kw)
    _same_store(str(tmp_path / 'jax'), str(tmp_path / 'port'))


def test_synth_store_of_given_lengths_keeps_its_draws(tmp_path):
    """The knobs at 0 draw nothing: a given-length store is what it was
    before they came (labels equal the class, features its center)."""
    store = synth_store.make_cexpr_store(str(tmp_path), [5, 7],
                                         ds=constants.C_EXPR_DB,
                                         val_lengths=[6])
    rng = np.random.default_rng(0)
    centers = [rng.normal(size=(8, d)) * 3.0 for d in (128, 768)]
    label = int(rng.integers(0, 8))
    video = rng.integers(0, 256, (5, 48, 48, 3), dtype=np.uint8)
    tdir = join(store['dataset_path'], 'features', 'compacted_48',
                'train', 'vid0')
    np.testing.assert_array_equal(np.load(join(tdir, 'video.npy')), video)
    want = centers[0][label] + rng.normal(size=(5, 128))
    np.testing.assert_array_equal(np.load(join(tdir, 'vggish.npy')),
                                  want.astype(np.float32))
    assert set(np.load(join(tdir, f'{constants.EXPR}.npy'))) == {label}


# ----------------------------------------------------------- validate_store
def _broken_store(root):
    """A MELD store with one of each defect the checks name."""
    store = jax_synth.make_meld_store(root, n_train=6, n_val=3, n_test=3,
                                      min_len=6, max_len=12,
                                      with_video=True)
    feat = join(root, 'features', 'compacted_48')
    # truncated payload
    path = join(feat, 'train', 'v0', 'bert.npy')
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) - 100)
    # stale recompacted video: fewer rows than video.npy
    video = np.load(join(feat, 'train', 'v1', 'video.npy'))
    np.save(join(feat, 'train', 'v1', 'video_48.npy'),
            np.zeros((len(video) - 1, 48, 48, 3), np.uint8))
    # an over-long stream the repair truncates
    vg = np.load(join(feat, 'val', 'v0', 'vggish.npy'))
    np.save(join(feat, 'val', 'v0', 'vggish.npy'),
            np.concatenate([vg, vg[:2]]))
    # a fold naming a trial the store lacks
    with open(join(store['folds_dir'], 'split-0', 'test.txt'), 'a') as f:
        f.write('test/ghost,1,a trial never extracted\n')
    # a mean/std cache older than the features
    cache = join(root, 'mean_std_info_fold-0.pkl')
    with open(cache, 'wb') as f:
        pickle.dump({}, f)
    os.utime(cache, (1, 1))
    return store


def _report(mod, store, **kw):
    return mod.validate(store['dataset_path'], constants.MELD,
                        folds_dir=store['folds_dir'], **kw).as_dict()


def test_validate_store_reports_equal_fvt_tpus(tmp_path):
    jax_vs = _tool('validate_store')
    clean = jax_synth.make_meld_store(str(tmp_path / 'clean'), n_train=4,
                                      n_val=2, n_test=2, with_video=True)
    for deep in (False, True):
        got = _report(validate_store, clean, deep=deep)
        assert got == _report(jax_vs, clean, deep=deep)
        assert got['ok'], got
    assert validate_store.main(['--dataset_path', clean['dataset_path'],
                                '--dataset_name', 'MELD', '--folds_dir',
                                clean['folds_dir'], '--deep']) == 0

    broken = _broken_store(str(tmp_path / 'broken'))
    got = _report(validate_store, broken, deep=True)
    assert got == _report(jax_vs, broken, deep=True)
    assert not got['ok']
    for kind in ('npy_truncated', 'recompacted_stale', 'frame_count_mismatch',
                 'fold_trial_not_in_store', 'mean_std_cache_stale'):
        assert kind in got['counts'], (kind, got['counts'])

    # --repair of two copies: the same actions and post-repair report
    reports = {}
    for name, mod in (('port', validate_store), ('jax', jax_vs)):
        root = str(tmp_path / f'repair_{name}')
        shutil.copytree(broken['dataset_path'], root)
        out = str(tmp_path / f'{name}.json')
        rc = mod.main(['--dataset_path', root, '--dataset_name', 'MELD',
                       '--folds_dir', join(root, 'folds', 'MELD'),
                       '--deep', '--repair', '--json', out])
        with open(out) as f:
            reports[name] = (rc, json.loads(f.read().replace(root, '<root>')))
    assert reports['port'] == reports['jax']
    rc, rep = reports['port']
    assert {a['action'] for a in rep['repairs']} >= {
        'salvaged_truncated', 'removed_stale_recompact', 'truncated_stream',
        'removed_stale_mean_std_cache'}
    # what the repair cannot fabricate stays: the salvaged bert.npy is now
    # shorter than its trial (an error, exit 1); the ghost trial a warning
    assert rc == 1 and not rep['ok']
    assert set(rep['post']['errors']) == {'frame_count_mismatch'}
    assert 'npy_truncated' not in rep['post']['counts']


# ----------------------------------------------------------- summarize_runs
def _perf(frame_wf1, ignore_classes=(None,)):
    out = {}
    for k, ign in enumerate(ignore_classes):
        base = frame_wf1 + 0.001 * k

        def atom(v):
            return {'master': v, 'per_cl': np.array([v])}

        out[ign] = {
            metric: {
                constants.FRAME_LEVEL: atom(base + shift),
                constants.VIDEO_LEVEL: {
                    vp: atom(base + shift + 0.01 + 0.002 * j)
                    for j, vp in enumerate(constants.VIDEO_PREDS)}}
            for metric, shift in ((constants.W_F1, 0.0),
                                  (constants.MACRO_F1, -0.1),
                                  (constants.CL_ACC, 0.1))}
    return out


def _run(root, name, ds, fold, seed, items, passed=True):
    d = join(root, name)
    os.makedirs(d)
    with open(join(d, 'config.yml'), 'w') as f:
        yaml.dump({'dataset_name': ds, 'model_name': 'LFAN',
                   'modality': 'vggish+bert+EXPR_continuous_label',
                   'fold_to_run': fold, 'seed': seed}, f)
    for item, perf in items.items():
        with open(join(d, f'{constants.TESTSET}-{item}-perf.pkl'),
                  'wb') as f:
            pickle.dump(perf, f)
    if passed:
        with open(join(d, 'passed.txt'), 'w') as f:
            f.write('Passed.')


def test_summarize_runs_equals_fvt_tpus(tmp_path):
    jax_sr = _tool('summarize_runs')
    root = str(tmp_path)
    for fold in range(2):
        for seed in range(2):
            _run(root, f'meld_f{fold}_s{seed}', constants.MELD, fold, seed,
                 {vp: _perf(0.4 + 0.1 * fold + 0.01 * seed)
                  for vp in constants.VIDEO_PREDS})
            _run(root, f'cexpr_f{fold}_s{seed}', constants.C_EXPR_DB, fold,
                 seed, {str(i): _perf(0.3 + 0.05 * fold, (None, 7))
                        for i in ('None', '7')})
    _run(root, 'unfinished', constants.MELD, 0, 0,
         {constants.FRM_VOTE: _perf(0.9)}, passed=False)
    for unfinished in (False, True):
        got = summarize_runs.summarize([root], unfinished)
        want = jax_sr.summarize([root], unfinished)
        assert json.dumps(got, sort_keys=True, default=str) == \
            json.dumps(want, sort_keys=True, default=str)
        assert summarize_runs.render(got) == jax_sr.render(want)
    assert len(got['groups']) == 5


# ---------------------------------------------------------- port_checkpoint
@pytest.mark.parametrize('name,modality', [
    ('LFAN', 'vggish+bert'), ('CAN', 'vggish+bert+mfcc'),
    ('MT', 'video+vggish')])
def test_port_checkpoint_byte_equal_and_reverse(tmp_path, name, modality):
    jax_pc = _tool('port_checkpoint')
    cfg = get_config(constants.MELD)
    cfg.update(model_name=name, modality=modality)
    model = init_model(types.SimpleNamespace(**cfg))
    state = model.state_dict()
    pt = str(tmp_path / 'model.pt')
    torch.save(state, pt)
    out = {}
    for tool, mod in (('port', port_checkpoint), ('jax', jax_pc)):
        out[tool] = str(tmp_path / f'{tool}.msgpack')
        mod.main(['--in', pt, '--out', out[tool], '--model_name', name,
                  '--modality', modality])
    with open(out['port'], 'rb') as a, open(out['jax'], 'rb') as b:
        assert a.read() == b.read()

    rev = {}
    for tool, mod in (('port', port_checkpoint), ('jax', jax_pc)):
        path = str(tmp_path / f'{tool}.pt')
        mod.main(['--reverse', '--in', out[tool], '--out', path,
                  '--model_name', name, '--modality', modality])
        rev[tool] = torch.load(path)
    assert rev['port'].keys() == rev['jax'].keys()
    for k, v in rev['jax'].items():
        assert torch.equal(rev['port'][k], v), k
    back = {k: v for k, v in rev['port'].items() if not is_dead_key(k, name)}
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    model.load_state_dict(back, strict=True)
