"""The port's own copies of fvt_tpu's jax-free modules, held against their
originals: constants and model/train configs equal name by name, the
numpy resize and windowing functions equal on seeded inputs (exact), the
streaming server core giving the same dispatches, padded rows and
output bits on the same multi-stream feed, the serving client the
same source but its docstring's package name, and the host side of the
audio preprocessing (``preprocess/{sharding,mfcc,egemaps}.py``) and of the
visual one (``preprocess/{compact,recompact,merge,au_ellipsoids}.py``;
``splits.py`` but its YAML writer) the same code below its docstrings,
with ``build_all_action_units``, ``divide``, ``annotated_index``, ``mfcc``,
``extract_mfcc``, ``egemaps_lld``, ``functionals_rows``,
``egemaps_per_frame``, ``extract_egemaps`` and ``COLUMNS`` exactly
equal on seeded signals.
"""
import numpy as np
import pytest

from fvt_tpu import constants as jax_constants
from fvt_tpu import streaming as jax_streaming
from fvt_tpu.config import defaults as jax_defaults
from fvt_tpu.config import model_config as jax_mc
from fvt_tpu.data import host_resize as jax_resize
from fvt_tpu.data import windowing as jax_windowing
from fvt_tpu.utils import rng as jax_rng
from fvt_tpu_torch import constants, streaming
from fvt_tpu_torch.config import defaults
from fvt_tpu_torch.config import model_config as mc
from fvt_tpu_torch.data import host_resize, windowing
from fvt_tpu_torch.utils import rng


def _public(module) -> dict:
    return {k: v for k, v in vars(module).items()
            if not k.startswith('_') and k.isupper()}


@pytest.mark.parametrize('copy,original', [(constants, jax_constants),
                                           (mc, jax_mc)],
                         ids=['constants', 'model_config'])
def test_every_public_constant_is_equal(copy, original):
    want, got = _public(original), _public(copy)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == value, name
        assert type(got[name]) is type(value), name


def test_train_defaults_are_fvt_tpu_defaults():
    want = jax_defaults.get_config(jax_constants.MELD)
    got = defaults.get_train_config()
    assert got and set(got) <= set(want)
    for key, value in got.items():
        assert want[key] == value, key


@pytest.mark.parametrize('n_in,n_out', [(256, 48), (64, 48), (48, 48),
                                        (40, 48), (97, 13)])
def test_resize_weights_equal(n_in, n_out):
    np.testing.assert_array_equal(host_resize.resize_weights(n_in, n_out),
                                  jax_resize.resize_weights(n_in, n_out))


def test_resize_frames_equal():
    video = np.random.default_rng(0).integers(
        0, 256, (3, 64, 56, 3), dtype=np.uint8)
    np.testing.assert_array_equal(host_resize.resize_frames(video, 48),
                                  jax_resize.resize_frames(video, 48))
    np.testing.assert_array_equal(
        host_resize.resize_frames_uint8(video, 48),
        jax_resize.resize_frames_uint8(video, 48))


@pytest.mark.parametrize('length,window,hop', [(1000, 300, 200),
                                               (700, 300, 200),
                                               (300, 300, 200),
                                               (250, 300, 200),
                                               (23, 8, 3), (5, 8, 3)])
def test_windowing_functions_equal(length, window, hop):
    rng_ = np.random.default_rng(length)
    assert windowing.window_starts(length, window, hop) == \
        jax_windowing.window_starts(length, window, hop)
    x = rng_.normal(size=(length, 5)).astype(np.float32)
    for got, want in zip(windowing.windowing(x, window, hop),
                         jax_windowing.windowing(x, window, hop)):
        np.testing.assert_array_equal(got, want)
    if length >= window:
        idx = windowing.window_index_matrix(length, window, hop)
        np.testing.assert_array_equal(
            idx, jax_windowing.window_index_matrix(length, window, hop))
        outs = rng_.normal(size=idx.shape + (7,)).astype(np.float32)
        np.testing.assert_array_equal(
            windowing.stitch_windows_np(outs, idx, length),
            jax_windowing.stitch_windows_np(outs, idx, length))
    else:
        np.testing.assert_array_equal(
            windowing.pad_short_window_indices(length, window),
            jax_windowing.pad_short_window_indices(length, window))
    if length > window:
        for quantum in (0, 100):
            assert windowing.ladder_len(length, window, quantum) == \
                jax_windowing.ladder_len(length, window, quantum)


def test_numpy_streams_equal():
    for args in [(0, '', 0), (7, 'stable_shuffle', 3), (2 ** 32 + 5, 'x', 1)]:
        np.testing.assert_array_equal(rng.np_rng(*args).random(8),
                                      jax_rng.np_rng(*args).random(8))


class _StubModel:
    """A serving model over numpy: per-frame logits that depend on the
    frame and on its place in the window, so a wrong window or row shows.
    A ``bfloat16`` spec takes ``ml_dtypes`` arrays (``fvt_tpu``'s server
    core) or their raw bits (the port's), widened to float32."""
    WB, T, C, D = 4, 12, 3, 5

    def __init__(self, dtype='float32'):
        self.calls = 0
        self.meta = {
            'model_name': 'LFAN', 'modality': 'feat', 'num_classes': self.C,
            'needs_mask': False, 'window_length': self.T, 'hop_length': 8,
            'shapes': {'b4xt12': {
                'window_batch': self.WB, 'seq_len': self.T,
                'inputs': {'feat': {'shape': [self.WB, self.T, self.D],
                                    'dtype': dtype}}}}}
        self.w = np.random.default_rng(9).normal(
            size=(self.D, self.C)).astype(np.float32)

    def call(self, inputs, length=None):
        assert length is None
        x = inputs['feat']
        if x.dtype == np.uint16:
            x = (x.astype(np.uint32) << 16).view(np.float32)
        elif x.dtype.name == 'bfloat16':
            x = x.astype(np.float32)
        assert x.shape == (self.WB, self.T, self.D) and x.dtype == np.float32
        self.calls += 1
        pos = np.arange(self.T, dtype=np.float32)[None, :, None]
        return (x @ self.w + 0.01 * pos).astype(np.float32)


def _feed_streams(mod, dtype='float32'):
    """3 streams of 40, 7 (shorter than a window) and 29 frames in ragged
    chunks, round-robin, through one dynamic-batching registry."""
    model = _StubModel(dtype)
    registry = mod.StreamingRegistry(model, dynamic_batch=True)
    rng_ = np.random.default_rng(4)
    lengths = (40, 7, 29)
    frames = [rng_.normal(size=(n, model.D)).astype(np.float32)
              for n in lengths]
    chunks = [[5, 1, 9, 13, 12], [3, 4], [11, 2, 16]]
    sids = [registry.open() for _ in lengths]
    parts = [[] for _ in lengths]
    pos = [0] * len(lengths)
    for step in range(max(map(len, chunks))):
        for i, sid in enumerate(sids):
            if step < len(chunks[i]):
                n = chunks[i][step]
                parts[i].append(registry.feed(
                    sid, {'feat': frames[i][pos[i]:pos[i] + n]}))
                pos[i] += n
    for i, sid in enumerate(sids):
        parts[i].append(registry.close(sid))
    assert pos == list(lengths)
    return parts, registry.batcher.dispatches, \
        registry.batcher.rows_padded, model.calls


def test_streaming_copy_behaves_as_the_original():
    want, want_dispatches, want_padded, want_calls = _feed_streams(
        jax_streaming)
    got, dispatches, padded, calls = _feed_streams(streaming)
    assert (dispatches, padded, calls) == (want_dispatches, want_padded,
                                           want_calls)
    assert dispatches >= 2
    for got_parts, want_parts in zip(got, want):
        assert len(got_parts) == len(want_parts)
        for (gs, gl), (ws, wl) in zip(got_parts, want_parts):
            assert gs == ws
            np.testing.assert_array_equal(gl, wl)
    for parts, n in zip(got, (40, 7, 29)):
        assert sum(len(p[1]) for p in parts) == n


def test_streaming_copy_serves_bfloat16_specs_as_the_original():
    """``--h2d_bf16_features``: the port's server core carries a bfloat16
    input as raw bits, rounded as ``fvt_tpu``'s ``ml_dtypes`` cast
    rounds, so the model sees the same values and the streams the same
    logits."""
    want, want_dispatches, want_padded, _ = _feed_streams(jax_streaming,
                                                          'bfloat16')
    got, dispatches, padded, _ = _feed_streams(streaming, 'bfloat16')
    assert (dispatches, padded) == (want_dispatches, want_padded)
    plain, _, _, _ = _feed_streams(streaming)
    for got_parts, want_parts, plain_parts in zip(got, want, plain):
        for (gs, gl), (ws, wl), (_, pl) in zip(got_parts, want_parts,
                                               plain_parts):
            assert gs == ws
            np.testing.assert_array_equal(gl, wl)
            assert len(gl) == 0 or not np.array_equal(gl, pl)


# ------------------------------------------------ copies of this slice
def test_rng_shuffles_equal():
    items = list(range(40))
    for seed in (0, 3, 2 ** 32 + 1):
        assert rng.stable_shuffle(items, seed, rounds=7) == \
            jax_rng.stable_shuffle(items, seed, rounds=7)
        assert rng.epoch_seed(seed, 5) == jax_rng.epoch_seed(seed, 5)


def test_io_copy_reads_and_writes_as_the_original(tmp_path):
    from fvt_tpu.utils import io as jax_io
    from fvt_tpu_torch.utils import io

    obj = {'a': np.arange(4), 'b': [1, 'x']}
    io.save_pickle(obj, str(tmp_path / 'x' / 'o.pkl'))
    got = jax_io.load_pickle(str(tmp_path / 'x' / 'o.pkl'))
    np.testing.assert_array_equal(got['a'], obj['a'])
    assert got['b'] == obj['b']
    np.save(tmp_path / 'feat.npy', np.arange(6.0).reshape(3, 2))
    for mmap in (True, False):
        np.testing.assert_array_equal(
            io.load_npy(str(tmp_path), 'feat', mmap),
            jax_io.load_npy(str(tmp_path), 'feat', mmap))
    assert io.npy_exists(str(tmp_path), 'feat') and \
        not io.npy_exists(str(tmp_path), 'none')


def test_tables_copy_draws_as_the_original():
    from fvt_tpu.utils import tables as jax_tables
    from fvt_tpu_torch.utils import tables

    r = np.random.default_rng(1)
    names = {i: f'class {i}' for i in range(4)}
    mtx, vec = r.random((4, 4)), r.random(5)
    assert tables.print_confusion_mtx(mtx, names) == \
        jax_tables.print_confusion_mtx(mtx, names)
    assert tables.print_vector(vec, names) == \
        jax_tables.print_vector(vec, names)
    rows = [['a', 1.5, None], ['-', 2, 'x']]
    assert tables.draw_table(['h', 'f', 't'], rows, ['t', 'f', 't'], 3) == \
        jax_tables.draw_table(['h', 'f', 't'], rows, ['t', 'f', 't'], 3)


def test_logger_copy_logs_as_the_original(tmp_path):
    import json
    from fvt_tpu.utils import logger as jax_logger
    from fvt_tpu_torch.utils import logger

    def defined(mod):
        return {k for k, v in vars(mod).items() if not k.startswith('_')
                and getattr(v, '__module__', None) == mod.__name__}

    assert defined(jax_logger) - defined(logger) == {'enable_jit_cache'}
    assert defined(logger) <= defined(jax_logger)
    records = []
    for mod, d in ((logger, tmp_path / 'port'), (jax_logger, tmp_path / 'j')):
        mod.init_logger(str(d), verbose=False)
        mod.log(mod.fmsg('start'))
        mod.get_logger().metrics({'f1': 0.5}, step=3)
        mod.init_logger(None, verbose=False)
        with open(d / 'log.json') as f:
            recs = [json.loads(line) for line in f]
        with open(d / 'log.txt') as f:
            lines = [line.split('] ', 1)[1] for line in f
                     if line.startswith('[')]
        for rec in recs:
            del rec['t'], rec['elapsed']
        records.append((recs, lines))
    assert records[0] == records[1]


def test_version_copy_checks_as_the_original():
    from fvt_tpu.preprocess import version as jax_version
    from fvt_tpu_torch.preprocess import version

    assert (version.EXTRACTOR_VERSION, version.CHANGELOG,
            version.STAMP_KEY) == (jax_version.EXTRACTOR_VERSION,
                                   jax_version.CHANGELOG,
                                   jax_version.STAMP_KEY)
    for info in ({}, version.stamp({}), {version.STAMP_KEY: 1}):
        assert version.check(dict(info), 'x.pkl') == \
            jax_version.check(dict(info), 'x.pkl')


def test_metrics_copy_computes_as_the_original():
    from fvt_tpu.train import metrics as jax_metrics
    from fvt_tpu_torch.train import metrics

    r = np.random.default_rng(2)
    x = r.normal(size=(20, 8)).astype(np.float32) * 40
    np.testing.assert_array_equal(metrics.softmax(x),
                                  jax_metrics.softmax(x))
    t, p = r.integers(0, 6, 50).tolist(), r.integers(0, 7, 50).tolist()
    for kind in (constants.W_F1, constants.MACRO_F1):
        got, want = (metrics.compute_f1_score(t, p, kind),
                     jax_metrics.compute_f1_score(t, p, kind))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert metrics.compute_class_acc(t, p) == \
        jax_metrics.compute_class_acc(t, p)
    np.testing.assert_array_equal(metrics.compute_confusion_matrix(t, p),
                                  jax_metrics.compute_confusion_matrix(t, p))
    data = {f'v{i}': {'labels': r.uniform(-1, 1, 30),
                      'preds': r.uniform(-1, 1, 30)} for i in range(3)}
    assert metrics.compute_regression_perf(data) == \
        jax_metrics.compute_regression_perf(data)


def test_fvt_store_cpp_is_the_original_but_its_header_comment():
    """The copy differs from native/fvt_store.cpp in two lines of its
    header comment only (the disk contract's source and how it is built):
    2 lines out, 3 in, all comments above the first #include."""
    import difflib
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, 'native', 'fvt_store.cpp')) as f:
        original = f.read().splitlines()
    with open(os.path.join(repo, 'fvt_tpu_torch', 'native',
                           'fvt_store.cpp')) as f:
        copy = f.read().splitlines()
    head = original.index('#include <cstdint>')
    assert copy[copy.index('#include <cstdint>'):] == original[head:]
    removed = [ln[2:] for ln in difflib.ndiff(original, copy)
               if ln.startswith('- ')]
    added = [ln[2:] for ln in difflib.ndiff(original, copy)
             if ln.startswith('+ ')]
    assert (len(removed), len(added)) == (2, 3)
    assert all(ln.startswith('//') for ln in removed + added)
    assert added[0] == ('// (the disk contract of the upstream '
                        'base/dataset.py:603-619).  The')


def test_client_is_the_original_but_its_package_name():
    """fvt_tpu_torch/client.py is fvt_tpu/client.py, its docstring's
    package name and the upstream file it cites by path aside: numpy and
    the standard library, the same wire protocol."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, 'fvt_tpu', 'client.py')) as f:
        original = f.read()
    with open(os.path.join(repo, 'fvt_tpu_torch', 'client.py')) as f:
        copy = f.read()
    doc_end = copy.index('"""', 3) + 3
    assert copy[doc_end:] == original[original.index('"""', 3) + 3:]
    doc = copy[:doc_end].replace('fvt_tpu_torch', 'fvt_tpu').splitlines()
    want = original[:original.index('"""', 3) + 3].splitlines()
    assert len(doc) == len(want)
    differ = [(got, line) for got, line in zip(doc, want) if got != line]
    assert len(differ) == 1
    assert differ[0][0].startswith('the upstream inference_challenge.py')
    assert differ[0][1].endswith('inference_challenge.py); this is the '
                                 'thin edge of the')
    assert copy != original


def _speech_like(seconds: float, seed: int) -> np.ndarray:
    """Voiced tone bursts over noise with a stretch of silence: voiced
    and unvoiced frames for the pitch tracker, zeros for the floors."""
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = (0.3 * np.sin(2 * np.pi * (150 + 40 * t) * t)
         * (np.sin(2 * np.pi * 0.7 * t) > 0)
         + 0.02 * r.standard_normal(len(t)))
    x[len(t) // 3:len(t) // 2] = 0
    return x


def test_sharding_copy_divides_as_the_original():
    from fvt_tpu.preprocess import sharding as jax_sharding
    from fvt_tpu_torch.preprocess import sharding

    seq = list(range(23))
    for n in (1, 2, 5, 23, 30):
        assert sharding.divide(n, seq) == jax_sharding.divide(n, seq)
        assert list(sharding.chunks_into_n(seq, n)) == \
            list(jax_sharding.chunks_into_n(seq, n))
        assert sharding.better_chunks_into_n(seq, n) == \
            jax_sharding.better_chunks_into_n(seq, n)
    for args in ((301, 30.0), (301, 29.97), (250, 25.0, 10.0), (0, 30.0),
                 (97, 30.0, 44.1)):
        got, want = (sharding.annotated_index(*args),
                     jax_sharding.annotated_index(*args))
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize('hop', [0.010, 1 / 29.97])
@pytest.mark.parametrize('stereo', [False, True], ids=['mono', 'stereo'])
def test_mfcc_copy_is_the_original(hop, stereo):
    from fvt_tpu.preprocess import mfcc as jax_mfcc
    from fvt_tpu_torch.preprocess import mfcc

    x = _speech_like(1.5, 5)
    if stereo:
        x = np.stack([x, 0.5 * x[::-1]], axis=1)
    got, want = mfcc.mfcc(x, hop_sec=hop), jax_mfcc.mfcc(x, hop_sec=hop)
    assert got.shape == want.shape and got.shape[1] == 39
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize('extract', ['mfcc', 'egemaps'])
def test_extract_copy_writes_the_original_file(tmp_path, extract):
    from fvt_tpu.preprocess import mfcc as jax_mfcc
    from fvt_tpu_torch.preprocess import melspec, mfcc

    wav = str(tmp_path / 'clip.wav')
    melspec.write_wav(wav, (_speech_like(2.0, 6) * 32767).astype(np.int16),
                      16000)
    idx = np.arange(0, 70, 3)  # past the end of both
    kw = ({'annotated_idx': idx, 'hop_sec': 1 / 30} if extract == 'mfcc'
          else {'length': 60, 'target_frequency': 30.0,
                'annotated_idx': idx})
    files = []
    for module, name in ((jax_mfcc, 'want'), (mfcc, 'got')):
        out = str(tmp_path / f'{name}.npy')
        getattr(module, f'extract_{extract}')(wav, out, **kw)
        files.append(np.load(out))
    want, got = files
    assert got.shape == (len(idx), 39 if extract == 'mfcc' else 88)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_egemaps_copy_is_the_original():
    from fvt_tpu.preprocess import egemaps as jax_egemaps
    from fvt_tpu_torch.preprocess import egemaps

    assert egemaps.COLUMNS == jax_egemaps.COLUMNS
    assert len(egemaps.COLUMNS) == 88
    x = _speech_like(2.5, 7)
    lld, want_lld = egemaps.egemaps_lld(x, 16000), \
        jax_egemaps.egemaps_lld(x, 16000)
    assert lld.keys() == want_lld.keys()
    for key, value in want_lld.items():
        assert np.array_equal(lld[key], value), key
    sm = egemaps.smooth_tracks(lld)
    n = len(sm['voiced'])
    starts = np.array([0, 7, 50, n - 100, n - 30, n - 1])
    ends = np.minimum(starts + 100, n)
    level = np.random.default_rng(8).normal(size=len(starts))
    assert np.array_equal(
        egemaps.functionals_rows(sm, starts, ends, level),
        jax_egemaps.functionals_rows(jax_egemaps.smooth_tracks(want_lld),
                                     starts, ends, level))
    got = egemaps.egemaps_per_frame(x, 16000, 40, 25.0)
    want = jax_egemaps.egemaps_per_frame(x, 16000, 40, 25.0)
    assert got.shape == (40, 88) and np.isfinite(got).all()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(egemaps.egemaps_functionals(x, 16000),
                          jax_egemaps.egemaps_functionals(x, 16000))


def _code_below_docstring(name: str) -> list:
    """(fvt_tpu's, the port's) source of ``preprocess/<name>.py`` below its
    docstring, the package name and the line breaks aside."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = []
    for package in ('fvt_tpu', 'fvt_tpu_torch'):
        with open(os.path.join(repo, package, 'preprocess',
                               f'{name}.py')) as f:
            text = f.read()
        code.append(' '.join(text[text.index('"""', 3) + 3:].replace(
            'fvt_tpu_torch', 'fvt_tpu').split()))
    return code


@pytest.mark.parametrize('name', ['sharding', 'mfcc', 'egemaps', 'compact',
                                  'recompact', 'merge', 'au_ellipsoids'])
def test_preprocess_copy_is_the_original_source(name):
    """Below their docstrings the copies are the originals' code, the
    package name in their imports and its line breaks aside."""
    original, copy = _code_below_docstring(name)
    assert copy == original


def test_splits_copy_is_the_original_but_its_yaml_writer():
    """``preprocess/splits.py`` is the original below its docstring, but
    that ``class_id.yaml`` is written by ``config/flat_yaml`` (no PyYAML):
    one import out, one in, the dump in one call."""
    original, copy = _code_below_docstring('splits')
    original = original.replace(' import yaml ', ' ').replace(
        'from fvt_tpu import constants ',
        'from fvt_tpu import constants from fvt_tpu.config import '
        'flat_yaml ').replace(
        "with open(join(d, 'class_id.yaml'), 'w') as f: "
        "yaml.dump(class_id, f)",
        "flat_yaml.dump(class_id, join(d, 'class_id.yaml'))")
    assert copy == original


def test_au_ellipsoids_copy_builds_the_original_maps():
    """``build_all_action_units`` (no dlib) equal on seeded landmarks, in
    both modes, for every basic expression and neutral, on a face, an
    out-of-image face and invalid landmarks."""
    from fvt_tpu.preprocess import au_ellipsoids as jax_aue
    from fvt_tpu_torch.preprocess import au_ellipsoids as aue

    rng = np.random.default_rng(11)
    faces = [rng.uniform(20, 100, (68, 2)), rng.uniform(-400, -200, (68, 2)),
             np.full((68, 2), np.inf)]
    for lms in faces:
        lms = [tuple(p) for p in lms]
        for cl in list(aue.EXP2AU) + [constants.NEUTRAL]:
            for kind in (aue.HEATMAP_AUNITS_LNMKS,
                         aue.HEATMAP_GENERIC_AUNITS_LNMKS):
                got = aue.build_all_action_units(lms, 120, 110, cl, kind)
                want = jax_aue.build_all_action_units(lms, 120, 110, cl,
                                                      kind)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
