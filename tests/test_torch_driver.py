"""The port's feature driver, shard merge and fold splits
(``fvt_tpu_torch/preprocess/{driver,merge,splits}.py``) against
``fvt_tpu``'s, on the CPU.

* One shard pair (``nparts=2``) of four trials, the probe injected in
  both (``fvt_tpu``'s patched in its module) and the wavs and compacted
  faces placed beforehand; one trial's probe fails.  Labels, BERT zeros
  and landmarks (one injected landmarker, failing on one frame) come out
  exactly equal, ``logmel.npy`` within one float16 unit on at most
  ``HALF_FLIPS`` of its elements, ``vggish.npy`` within ``EMBED_RTOL``
  of the largest magnitude (``fvt_tpu``'s params carried over by
  ``vggish_state_from_flax``), and the ``dataset_info`` and
  ``processing_records`` pickles equal; then ``merge`` of the two shards
  equals ``fvt_tpu``'s.
* ``probe_video`` through a stand-in ``ffprobe`` on ``PATH``: ``nb_frames``
  or the counted packets, fps from ``r_frame_rate``; ``IOError`` without
  it; ``main`` end to end through it with ``--vggish_pth`` and
  ``--mfcc``.
* ``textalign``: the sentence split, the token alignment and the BERT
  sum-of-last-4 extraction (a stand-in tokenizer and model) equal
  ``fvt_tpu``'s.
* ``splits.main``'s fold files equal ``fvt_tpu``'s, and its
  ``class_id.yaml`` (written without PyYAML) loads to the same map.
* The refusal to run without a card.
"""
import json
import os
import pickle
import stat
import sys
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fvt_tpu.models.vggish import VGGish as FlaxVGGish
from fvt_tpu.preprocess import driver as jax_driver
from fvt_tpu.preprocess import merge as jax_merge
from fvt_tpu.preprocess import splits as jax_splits
from fvt_tpu.preprocess import textalign as jax_textalign
from fvt_tpu_torch.models.from_jax import vggish_state_from_flax
from fvt_tpu_torch.models.vggish import VGGish
from fvt_tpu_torch.preprocess import (driver, melspec, merge, splits,
                                      textalign)

FPS = 25.0
LENGTHS = {'c0': 20, 'c1': 31, 'c2': 12}
BROKEN = 'c3'
FOLD = 'c0,0,hello there\nc1,3,\nc2,5,more, text\nc3,1,\n'
HALF_FLIPS = 2e-3
EMBED_RTOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread_x64_off():
    n = torch.get_num_threads()
    was_x64 = bool(jax.config.jax_enable_x64)
    torch.set_num_threads(1)
    jax.config.update('jax_enable_x64', False)
    yield
    jax.config.update('jax_enable_x64', was_x64)
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def vggish():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(
        lambda k: FlaxVGGish().init(k, jnp.zeros((1, 96, 64))),
        jax.random.key(0))['params']

    def fill(path, leaf):
        if path[-1].key == 'kernel':
            a = rng.standard_normal(leaf.shape, np.float32)
            return a / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    model = VGGish().eval()
    model.load_state_dict(vggish_state_from_flax(params), strict=True)
    return params, model


def probe(path):
    trial = os.path.basename(path).split('.')[0]
    if trial == BROKEN:
        raise IOError(f'cannot open video {path}')
    return FPS, LENGTHS[trial]


def landmarker(img):
    if img[0, 0, 0] == 7:
        raise ValueError('no face')
    return np.stack([np.arange(68) + img[0, 0, 0],
                     np.arange(68) * 0.5 + img[1, 1, 1]], axis=1)


def make_store(root) -> tuple:
    """folds, videos, and for each of two output roots the wavs and the
    compacted faces of every trial."""
    rng = np.random.default_rng(1)
    (root / 'folds' / 'split-0').mkdir(parents=True)
    (root / 'folds' / 'split-0' / 'train.txt').write_text(FOLD)
    (root / 'videos').mkdir()
    outs = [root / 'port', root / 'jax']
    for trial, n in {**LENGTHS, BROKEN: 5}.items():
        (root / 'videos' / f'{trial}.mp4').write_bytes(b'')
        x = rng.integers(-3000, 3000, int(n / FPS * 16000) + 800, np.int16)
        faces = rng.integers(0, 256, (n, 32, 32, 3), np.uint8)
        faces[n // 2, 0, 0, 0] = 7  # the landmarker fails there
        for out in outs:
            wav = out / 'features' / 'wav' / f'{trial}.wav'
            wav.parent.mkdir(parents=True, exist_ok=True)
            melspec.write_wav(str(wav), x, 16000)
            tdir = out / 'features' / 'compacted_48' / trial
            tdir.mkdir(parents=True)
            np.save(tdir / 'video.npy', faces)
    return str(root / 'folds'), str(root / 'videos'), outs


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def test_shards_and_merge_match_fvt_tpu(tmp_path, monkeypatch, vggish):
    params, model = vggish
    folds, videos, (port_out, jax_out) = make_store(tmp_path)
    monkeypatch.setattr(jax_driver, 'probe_video', probe)
    for module in (driver.audio_mod, jax_driver.audio_mod):
        monkeypatch.setattr(module, 'has_ffmpeg', lambda: False)
    for part in range(2):
        driver.PreprocessingDriver(
            'MELD', 'train', part, 2, videos, str(port_out), folds,
            vggish=model, landmarker=landmarker, probe=probe,
            device='cpu').run()
        jax_driver.PreprocessingDriver(
            'MELD', 'train', part, 2, videos, str(jax_out), folds,
            vggish_params=params, landmarker=landmarker).run()

    for trial, n in LENGTHS.items():
        got_dir = port_out / 'features' / 'compacted_48' / trial
        want_dir = jax_out / 'features' / 'compacted_48' / trial
        for f in ('EXPR_continuous_label', 'bert', 'landmark'):
            got, want = np.load(got_dir / f'{f}.npy'), np.load(
                want_dir / f'{f}.npy')
            assert got.dtype == want.dtype and len(got) == n, f
            np.testing.assert_array_equal(got, want)
        assert not np.load(got_dir / 'landmark.npy')[n // 2].any()
        got, want = np.load(got_dir / 'logmel.npy'), np.load(
            want_dir / 'logmel.npy')
        assert got.dtype == want.dtype == np.float16
        assert got.shape == want.shape == (n, 96, 64)
        ulp = np.spacing(np.maximum(np.abs(want), np.abs(got)))
        diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert (diff <= ulp).all()
        assert np.count_nonzero(diff) <= HALF_FLIPS * diff.size
        got, want = np.load(got_dir / 'vggish.npy'), np.load(
            want_dir / 'vggish.npy')
        assert got.dtype == want.dtype and got.shape == want.shape == (n,
                                                                       128)
        assert np.abs(got - want).max() <= EMBED_RTOL * np.abs(want).max()
    assert not (port_out / 'features' / 'compacted_48' / BROKEN /
                'logmel.npy').exists()

    feat = [str(out / 'features') for out in (port_out, jax_out)]
    for part in range(2):
        for kind in ('dataset_info', 'processing_records'):
            name = f'{kind}_MELD_train_2_{part}.pkl'
            got, want = (_load(join(f, name)) for f in feat)
            assert got == want, name
    records = _load(join(feat[0], 'processing_records_MELD_train_2_1.pkl'))
    issues = {r['processing_record']['trial']:
              r['processing_record']['issues'] for r in records}
    assert issues == {'c2': [], BROKEN: [
        f'video probe failed: cannot open video {join(videos, "c3.mp4")}']}

    got = merge.merge_results(feat[0], 'MELD', 'train')
    want = jax_merge.merge_results(feat[1], 'MELD', 'train')
    assert got == want and got['trial'] == ['c0', 'c1', 'c2']
    for kind in ('dataset_info', 'processing_records'):
        assert _load(join(feat[0], f'{kind}_MELD_train.pkl')) == _load(
            join(feat[1], f'{kind}_MELD_train.pkl'))


FFPROBE = '''import json, os, sys
info = json.load(open(sys.argv[-1] + '.json'))
if '-count_packets' in sys.argv:
    info = {'nb_read_packets': info.pop('packets')}
else:
    info.pop('packets', None)
print(json.dumps({'streams': [info]}))
'''


def _ffprobe_on_path(tmp_path, monkeypatch):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    path = bin_dir / 'ffprobe'
    path.write_text(f'#!{sys.executable}\n{FFPROBE}')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv('PATH', str(bin_dir))


def _video(tmp_path, name, **info) -> str:
    path = tmp_path / name
    path.write_bytes(b'')
    (tmp_path / f'{name}.json').write_text(json.dumps(info))
    return str(path)


def test_probe_video_through_ffprobe(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(IOError, match='ffprobe is not on PATH'):
        driver.probe_video(str(tmp_path / 'none.mp4'))
    _ffprobe_on_path(tmp_path, monkeypatch)
    assert driver.probe_video(_video(
        tmp_path, 'a.mp4', r_frame_rate='25/1', nb_frames='300')) == (25.0,
                                                                      300)
    fps, n = driver.probe_video(_video(
        tmp_path, 'b.mkv', r_frame_rate='30000/1001', nb_frames='N/A',
        packets='42'))
    assert (fps, n) == (30000 / 1001, 42)
    assert driver.probe_video(_video(
        tmp_path, 'c.webm', r_frame_rate='24/1', packets='7')) == (24.0, 7)
    for bad in ({'r_frame_rate': '0/0', 'nb_frames': '5'},
                {'r_frame_rate': '25/1', 'nb_frames': '0'}):
        with pytest.raises(IOError, match='bad fps/frame-count'):
            driver.probe_video(_video(tmp_path, 'd.mp4', **bad))
    with pytest.raises(IOError, match='cannot probe video'):
        driver.probe_video(str(tmp_path / 'missing.mp4'))


def test_main_through_ffprobe(tmp_path, monkeypatch, vggish):
    _, model = vggish
    folds, videos, (out, _) = make_store(tmp_path)
    _ffprobe_on_path(tmp_path, monkeypatch)
    for trial, n in {**LENGTHS, BROKEN: 5}.items():
        (tmp_path / 'videos' / f'{trial}.mp4.json').write_text(json.dumps(
            {'r_frame_rate': '25/1', 'nb_frames': str(n)}))
    pth = str(tmp_path / 'vggish.pth')
    torch.save(model.state_dict(), pth)
    records = driver.main(['--dataset_name', 'MELD', '--split', 'train',
                           '--video_root', videos, '--output_root',
                           str(out), '--folds_dir', folds, '--vggish_pth',
                           pth, '--mfcc'], device='cpu')
    assert [r['processing_record']['issues'] for r in records] == [[]] * 4
    tdir = out / 'features' / 'compacted_48' / 'c1'
    assert np.load(tdir / 'vggish.npy').shape == (31, 128)
    assert np.load(tdir / 'mfcc.npy').shape == (31, 39)
    info = _load(out / 'features' / 'dataset_info_MELD_train_1_0.pkl')
    assert info['length'] == [20, 31, 12, 5]


class Tokenizer:
    """``encode_plus`` of a BERT tokenizer: a word a token, CLS and SEP
    around, padded to ``max_length``."""
    cls_token_id, sep_token_id = 101, 102

    def encode_plus(self, sentence, add_special_tokens, max_length,
                    padding, truncation, return_attention_mask,
                    return_tensors):
        ids = [self.cls_token_id] + [200 + sum(map(ord, w)) % 700
                                     for w in sentence.split()]
        ids = (ids + [self.sep_token_id])[:max_length]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        ids += [0] * (max_length - len(ids))
        return {'input_ids': torch.tensor([ids]),
                'attention_mask': torch.tensor([mask])}


class Bert(torch.nn.Module):
    """13 hidden states, each a scaled embedding of the ids."""

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(1000, 768)
        torch.nn.init.normal_(self.emb.weight,
                              generator=torch.Generator().manual_seed(0))

    def forward(self, input_ids, token_type_ids, attention_mask):
        e = self.emb(input_ids) * attention_mask[..., None]
        return type('Out', (), {'hidden_states': tuple(
            e * (1 + 0.1 * i) for i in range(13))})


def test_textalign_matches_fvt_tpu():
    text = 'Oh no. You did what?! I cannot, I will not believe it.'
    assert textalign.split_sentences(text) == \
        jax_textalign.split_sentences(text)
    tok, bert = Tokenizer(), Bert().eval()
    got = textalign.extract_word_embedding(text, tok, bert, max_length=16)
    want = jax_textalign.extract_word_embedding(text, tok, bert,
                                                max_length=16)
    assert got.shape == want.shape == (12, 768)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match='too long'):
        textalign.extract_word_embedding(text, tok, bert, max_length=6)
    rng = np.random.default_rng(3)
    for n_tok, idx in ((5, np.arange(12)), (20, np.arange(7)),
                       (3, np.array([0, 0, 1, 2, 2, 3]))):
        emb = rng.normal(size=(n_tok, 768)).astype(np.float32)
        np.testing.assert_array_equal(
            textalign.align_word_embedding_new(emb, idx),
            jax_textalign.align_word_embedding_new(emb, idx))


def test_splits_match_fvt_tpu(tmp_path):
    csv = tmp_path / 'labels.csv'
    rows = ['video,label,text'] + [f'v{i},{i % 7},line {i}, with a comma'
                                   for i in range(23)]
    csv.write_text('\n'.join(rows) + '\n')
    for name, module in (('port', splits), ('jax', jax_splits)):
        module.main(['--labels_csv', str(csv), '--folds_dir',
                     str(tmp_path / name), '--num_folds', '3'])
    for k in range(3):
        for f in ('train.txt', 'val.txt', 'test.txt'):
            got = (tmp_path / 'port' / f'split-{k}' / f).read_text()
            assert got == (tmp_path / 'jax' / f'split-{k}' / f).read_text()
            assert got
        got, want = (yaml.safe_load((tmp_path / name / f'split-{k}' /
                                     'class_id.yaml').read_text())
                     for name in ('port', 'jax'))
        assert got == want and len(got) == 8


def test_driver_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        driver.PreprocessingDriver('MELD', 'train', 0, 1, str(tmp_path),
                                   str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        driver.main(['--dataset_name', 'MELD', '--split', 'train',
                     '--video_root', str(tmp_path), '--output_root',
                     str(tmp_path), '--folds_dir', str(tmp_path)])
