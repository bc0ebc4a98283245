"""The port's config, checkpoint and store readers against ``fvt_tpu``'s.

* ``config.flat_yaml`` reads what ``yaml.safe_load`` reads from the
  ``config.yml`` files ``fvt_tpu`` writes (``parse_input`` in TRAINING
  mode and ``Trainer.save_args``, for the three datasets, with a path
  folded over lines, ``''``, timestamp-like strings, ``1.0e-07``, ``'1'``
  and ``'yes'``) and from ``class_id.yaml``; what it writes reads back
  the same through ``yaml.safe_load``; other YAML raises, naming the line.
* ``models.checkpoint.msgpack_restore`` gives, bit for bit, the tree
  ``flax.serialization.msgpack_restore`` gives for an ``fvt_tpu`` LFAN's
  ``model.msgpack`` and for numpy scalars; a chunked array raises.
* ``get_config`` equals ``fvt_tpu``'s for every dataset; ``_parse_eval``
  gives ``fvt_tpu``'s namespace for the same run directory.
* On a ``tests/synth_store.py`` store: ``DataArranger``, the mean/std,
  ``ExampleBuilder``, ``EvalLoader.batches`` (with and without the host
  crop), the native gathers, ``compute_perf`` and the report equal
  ``fvt_tpu``'s.
"""
import datetime as dt
import os
import sys
from os.path import join
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fvt_tpu import constants  # noqa: E402
from fvt_tpu_torch.config import flat_yaml  # noqa: E402

LONG_PATH = '/data/a store with spaces/' + 'challenge set ' * 8 + 'root'


def _same(got, want):
    assert list(got) == list(want) or set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == v and type(got[k]) is type(v), (k, got[k], v)


@pytest.mark.parametrize('ds', [constants.MELD, constants.C_EXPR_DB,
                                constants.C_EXPR_DB_CHALLENGE])
def test_reads_config_yml_written_by_parse_input(tmp_path, ds):
    from fvt_tpu.config.parse import parse_input

    outd = str(tmp_path / 'run')
    parse_input(['--dataset_name', ds, '--outd', outd,
                 '--dataset_path', LONG_PATH, '--exp_id', '',
                 '--save_path', '2026-10-17', '--opt__milestone', '1',
                 '--emotion', 'yes', '--opt__min_lr', '1e-07'])
    with open(join(outd, 'config.yml')) as f:
        text = f.read()
    assert '\n  ' in text  # the long path is folded
    assert "1.0e-07" in text and "'1'" in text and "'yes'" in text
    want = yaml.safe_load(text)
    assert want['dataset_path'] == LONG_PATH and want['exp_id'] == ''
    _same(flat_yaml.loads(text), want)


def test_reads_config_yml_written_by_save_args(tmp_path):
    from fvt_tpu.config.defaults import get_config
    from fvt_tpu.train.trainer import Trainer

    cfg = get_config(constants.C_EXPR_DB)
    cfg.update(t0=dt.datetime(2026, 10, 17, 20, 26, 9, 733258),
               tend=dt.datetime(2026, 10, 17, 21, 0), dataset_path=LONG_PATH,
               fd_exp=None, case_best_model=None, eval_set='test')
    path = str(tmp_path / 'config.yml')
    Trainer.save_args(SimpleNamespace(args=SimpleNamespace(**cfg)), path)
    got = flat_yaml.load(path)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert want['t0'] == '2026-10-17 20:26:09.733258'
    _same(got, want)


def test_reads_class_id_yaml(tmp_path):
    from synth_store import CLASSES, COMPOUND_CLASSES

    for classes in (CLASSES, COMPOUND_CLASSES):
        text = yaml.dump({c: i for i, c in enumerate(classes)})
        _same(flat_yaml.loads(text), yaml.safe_load(text))


def test_writer_round_trips_through_pyyaml():
    from fvt_tpu_torch.config.defaults import get_config

    cfg = get_config(constants.MELD)
    cfg.update(dataset_path=LONG_PATH, a='', b='1', c='yes', d='2026-10-17',
               e='a: b', f="it's", g='#x', h='null', i=None, j=1e20,
               k=float('inf'), m=-0.0, n='0.5', o=' lead', p='tab\there',
               q='line\nbreak', r='caf\u00e9', s='~', t=1e-07, u=-3)
    text = flat_yaml.dumps(cfg)
    _same(yaml.safe_load(text), cfg)
    _same(flat_yaml.loads(text), cfg)
    _same(flat_yaml.loads(yaml.dump(cfg)), cfg)
    _same(flat_yaml.loads(yaml.dump(cfg, width=20)), cfg)


@pytest.mark.parametrize('text,line', [
    ('a: 1\nb:\n  c: 2\n', 2), ('a: 1\nb:\n- 1\n', 3), ('a: [1, 2]\n', 1),
    ('a: {b: 1}\n', 1), ('a: &x 1\n', 1), ('a: !!str 1\n', 1),
    ('a: |\n  text\n', 1), ('a: 2026-10-17\n', 1), ('- 1\n', 1),
    ("a: 'open\n", 1), ('a: "\\q"\n', 1), ('a: 1\na: 2\n', 2),
    ('---\na: 1\n', 1), ('a: 1 b: 2\n', 1)],
    ids=['nested', 'list', 'flow-list', 'flow-map', 'anchor', 'tag',
         'block-scalar', 'timestamp', 'top-list', 'unterminated',
         'bad-escape', 'repeated-key', 'document-marker', 'two-entries'])
def test_other_yaml_is_refused_naming_the_line(text, line):
    with pytest.raises(flat_yaml.FlatYamlError, match=f'line {line}'):
        flat_yaml.loads(text)


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


# ---------------------------------------------------------------- msgpack
def _tree_equal(got, want, path=''):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _tree_equal(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope='module')
def flax_lfan():
    from fvt_tpu.models.models import LFAN

    tcn = {'vggish': [16, 16, 8, 8], 'bert': [24, 24, 16, 16]}
    model = LFAN(modality=('vggish', 'bert'), output_dim=7, tcn_channel=tcn,
                 encoder_dim={m: c[-1] for m, c in tcn.items()})
    x = {'vggish': np.zeros((1, 8, 128), np.float32),
         'bert': np.zeros((1, 8, 768), np.float32)}
    return (*flax_variables(model, x, 0), tcn)


def test_msgpack_reader_is_flax_bit_for_bit(flax_lfan, tmp_path):
    import torch
    from flax import serialization
    from fvt_tpu_torch.models.checkpoint import (load_best_model,
                                                 msgpack_restore)
    from fvt_tpu_torch.models.from_jax import state_from_flax
    from fvt_tpu_torch.models.models import LFAN

    params, stats, tcn = flax_lfan
    blob = serialization.to_bytes({'params': params, 'batch_stats': stats})
    _tree_equal(msgpack_restore(blob), serialization.msgpack_restore(blob))
    scalars = serialization.to_bytes({
        'f32': np.float32(1.5), 'i64': np.int64(-7), 'u8': np.uint8(200),
        'f64': np.float64(2.25), 'bool': np.bool_(True), 'int': 3,
        'neg': -40000, 'big': 2 ** 40, 'float': 0.1, 'str': 'x' * 40,
        'none': None, 'empty': np.zeros((0, 3), np.float16)})
    _tree_equal(msgpack_restore(scalars),
                serialization.msgpack_restore(scalars))

    path = str(tmp_path / 'model.msgpack')
    with open(path, 'wb') as f:
        f.write(blob)
    model = LFAN(('vggish', 'bert'), 7, tcn_channel=tcn,
                 encoder_dim={m: c[-1] for m, c in tcn.items()})
    load_best_model(model, path, ('vggish', 'bert'))
    want = state_from_flax(params, stats, ('vggish', 'bert'))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_msgpack_reader_refuses_chunked_arrays(monkeypatch):
    from flax import serialization
    from fvt_tpu_torch.models.checkpoint import MsgpackError, msgpack_restore

    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 8)
    blob = serialization.msgpack_serialize(
        {'w': np.arange(6, dtype=np.float32)})
    with pytest.raises(MsgpackError, match='chunked'):
        msgpack_restore(blob)


# ----------------------------------------------------------------- config
@pytest.mark.parametrize('ds', [constants.MELD, constants.C_EXPR_DB,
                                constants.C_EXPR_DB_CHALLENGE])
def test_get_config_is_fvt_tpus(ds):
    from fvt_tpu.config.defaults import get_config as jax_get_config
    from fvt_tpu_torch.config.defaults import get_config

    _same(get_config(ds), jax_get_config(ds))


def test_training_parse_writes_fvt_tpus_config_yml(tmp_path):
    from fvt_tpu.config.parse import parse_input as jax_parse
    from fvt_tpu_torch.config.parse import parse_input

    texts = []
    for name, parse in (('port', parse_input), ('fvt_tpu', jax_parse)):
        outd = str(tmp_path / name)
        ns = parse(['--dataset_name', constants.C_EXPR_DB, '--outd', outd,
                    '--dataset_path', LONG_PATH, '--opt__lr', '0.01',
                    '--modality', 'vggish+bert+EXPR_continuous_label'])
        assert ns.mode == constants.TRAINING
        with open(join(outd, 'config.yml')) as f:
            cfg = yaml.safe_load(f)
        assert cfg.pop('outd') == outd
        texts.append((cfg.pop('t0'), cfg))
    assert texts[0][0][:4] == texts[1][0][:4] == str(dt.date.today().year)
    _same(texts[0][1], texts[1][1])


def test_parse_eval_gives_fvt_tpus_namespace(tmp_path):
    from fvt_tpu.config.defaults import get_config
    from fvt_tpu.config.parse import parse_input as jax_parse
    from fvt_tpu_torch.config.parse import parse_input

    run = tmp_path / 'run'
    os.makedirs(run)
    folds = tmp_path / 'folds' / constants.C_EXPR_DB_CHALLENGE
    os.makedirs(folds)
    cfg = get_config(constants.MELD)
    cfg.update(train_p=10.0, dataset_path=LONG_PATH,
               folds_dir=str(tmp_path / 'folds' / constants.MELD),
               t0=str(dt.datetime(2026, 1, 2, 3, 4, 5)))
    with open(run / 'config.yml', 'w') as f:
        yaml.dump(cfg, f)
    argv = ['--mode', 'EVALUATION', '--fd_exp', str(run), '--dataset_path',
            str(tmp_path / 'store'), '--eval_set', 'val',
            '--eval_bucket_quantum', '16', '--case_best_model', 'x']
    want, got = vars(jax_parse(argv)), vars(parse_input(argv))
    assert want['folds_dir'] == str(folds) and want['train_p'] == 100.0
    for ns in (want, got):
        assert isinstance(ns.pop('t0'), dt.datetime)
    _same(got, want)


# ------------------------------------------------------------------ store
@pytest.fixture(scope='module')
def cexpr_store(tmp_path_factory):
    from synth_store import make_cexpr_store
    from fvt_tpu.data import native_store as jax_native
    from fvt_tpu_torch.data import native_store

    assert jax_native.ensure_built() and native_store.ensure_built()
    root = tmp_path_factory.mktemp('cexpr')
    store = make_cexpr_store(str(root / 'store'), ds=constants.C_EXPR_DB,
                             n_train=5, n_val=4, min_len=5, max_len=40,
                             seed=2, video_hw=64)
    args = dict(dataset_name=constants.C_EXPR_DB, use_other_class=False,
                train_p=100.0, valid_p=100.0, test_p=100.0, seed=0)
    return store, args


def _arrangers(store, args):
    from fvt_tpu.data.arranger import DataArranger as JaxArranger
    from fvt_tpu.experiment import Experiment as JaxExperiment
    from fvt_tpu_torch.data.arranger import DataArranger

    ns = SimpleNamespace(**args)
    info = JaxExperiment(SimpleNamespace(
        dataset_name=constants.C_EXPR_DB, dataset_path=store['dataset_path'],
        fold_to_run=0, folds_dir=store['folds_dir'],
        modality='video')).load_dataset_info()
    folds = join(store['folds_dir'])
    return (DataArranger(ns, info, store['dataset_path'], 0, folds),
            JaxArranger(ns, info, store['dataset_path'], 0, folds))


def _equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_arranger_and_mean_std_are_fvt_tpus(cexpr_store):
    store, args = cexpr_store
    port, jax_ = _arrangers(store, args)
    assert port.cl_to_int == jax_.cl_to_int
    _equal(port.data_per_split, jax_.data_per_split)
    for windowing in (True, False):
        _equal(port.generate_partitioned_trial_list(16, 8, windowing),
               jax_.generate_partitioned_trial_list(16, 8, windowing))
    lists = port.generate_partitioned_trial_list(16, 8, windowing=False)
    _equal(port.calculate_mean_std(lists), jax_.calculate_mean_std(lists))
    sub = dict(args, train_p=50.0)
    _equal(_arrangers(store, sub)[0].data_per_split,
           _arrangers(store, sub)[1].data_per_split)


@pytest.mark.parametrize('center_crop,use_native', [(None, True),
                                                    (40, True), (40, False)])
def test_builder_and_eval_batches_are_fvt_tpus(cexpr_store, center_crop,
                                               use_native):
    from fvt_tpu.data.dataset import ExampleBuilder as JaxBuilder
    from fvt_tpu.data.loader import EvalLoader as JaxLoader
    from fvt_tpu_torch.data.dataset import ExampleBuilder
    from fvt_tpu_torch.data.loader import EvalLoader

    store, args = cexpr_store
    port, jax_ = _arrangers(store, args)
    lists = port.generate_partitioned_trial_list(16, 8, windowing=True)
    mean_std = port.calculate_mean_std(
        port.generate_partitioned_trial_list(16, 8, windowing=False))
    kw = dict(modality=['video', 'vggish', 'bert', constants.EXPR],
              window_length=16, mean_std=mean_std, use_native=use_native)
    builders = ExampleBuilder(**kw), JaxBuilder(**kw)
    for item in lists[constants.TRAINSET][:6]:
        _equal(builders[0].build(item, center_crop=center_crop),
               builders[1].build(item, center_crop=center_crop))
    data = lists[constants.VALIDSET]
    got = list(EvalLoader(data, builders[0], bucket_quantum=16).batches(
        3, windowed_threshold=16, center_crop=center_crop))
    want = list(JaxLoader(data, builders[1], bucket_quantum=16).batches(
        3, windowed_threshold=16, center_crop=center_crop))
    assert len(got) == len(want) > 1
    _equal(got, want)
    assert got[0][0]['video'].shape[-2] == (center_crop or 48)


def test_native_gathers_are_fvt_tpus(cexpr_store):
    from fvt_tpu.data import native_store as jax_native
    from fvt_tpu_torch.data import native_store

    store, _ = cexpr_store
    tdir = join(store['dataset_path'], 'features', 'compacted_48', 'train',
                'vid0')
    idx = np.array([0, 3, 2, 2, 4])
    for name in ('bert.npy', 'video.npy', 'EXPR_continuous_label.npy'):
        got = native_store.gather_rows(join(tdir, name), idx)
        assert got is not None
        _equal(got, jax_native.gather_rows(join(tdir, name), idx))
    for crop in (None, 40):
        got = native_store.gather_resize_rows(join(tdir, 'video.npy'), idx,
                                              48, crop=crop)
        assert got is not None and got.shape[1] == (crop or 48)
        _equal(got, jax_native.gather_resize_rows(join(tdir, 'video.npy'),
                                                  idx, 48, crop=crop))
    assert native_store.gather_rows(join(tdir, 'bert.npy'),
                                    np.array([10 ** 6])) is None


@pytest.mark.parametrize('ds,other', [(constants.C_EXPR_DB, True),
                                      (constants.C_EXPR_DB_CHALLENGE, False),
                                      (constants.MELD, False)])
def test_compute_perf_and_report_are_fvt_tpus(ds, other):
    from fvt_tpu.train import metrics as jax_metrics
    from fvt_tpu_torch.train import metrics

    rng = np.random.default_rng(5)
    ncls = 8 if other else 7
    data = {f'v{i}': {'labels': np.full(n, i % ncls, np.int64),
                      'logits': rng.normal(size=(n, ncls)).astype(np.float32)}
            for i, n in enumerate((5, 9, 14, 3, 30, 7, 11, 8, 6, 12))}
    got = metrics.compute_perf(data, ds, other)
    want = jax_metrics.compute_perf(data, ds, other)
    _equal(got, want)
    int_to_cl = {i: f'class {i}' for i in range(ncls)}
    for tracker, jax_tracker in zip(
            metrics.build_trackers(ds, other).values(),
            jax_metrics.build_trackers(ds, other).values()):
        assert tracker.report(got, int_to_cl) == \
            jax_tracker.report(want, int_to_cl)
        tracker.append(got)
        jax_tracker.append(want)
        assert tracker.best_status_str == jax_tracker.best_status_str
