"""The port's audio extractors (``fvt_tpu_torch/preprocess/audio.py``)
against ``fvt_tpu``'s, on the CPU, on seeded 16-bit wavs.

``fvt_tpu`` runs with ``jax_enable_x64`` off (switched off for the file
and restored), its VGGish jitted once for the file (its extractor caches
the jit by the params object, which a module fixture holds).

* ``extract_logmel``'s ``logmel.npy`` files: float16, the same shape, and
  every element within one float16 unit in the last place of
  ``fvt_tpu``'s.  The float32 log-mels differ by ~1e-6 (the float32 FFT
  of ``fvt_tpu`` against the port's float64 one), which moves an element
  across a float16 rounding boundary now and then: at most
  ``HALF_FLIPS`` of the elements may differ, by that one unit.  With and
  without ``annotated_idx``, indices past the end included.
* ``extract_vggish_embeddings`` at ``input_size=8`` on a 1 s wav (31
  patches: four chunks, the last short), ``fvt_tpu``'s params carried
  over by ``from_jax.vggish_state_from_flax``: within 1e-4 of the
  largest magnitude; row i is patch i + 1's embedding (the reference's
  csv header quirk); the annotated gather edge-pads; a wav of one patch
  leaves no row and degrades to zeros.
* ``vggish_from_pth`` loads an upstream-named state_dict strictly; a
  VGGish on another device than the patches is refused.
* every entry point refuses to run without a card when ``device`` is
  None.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.vggish import VGGish as FlaxVGGish
from fvt_tpu.preprocess import audio as jax_audio
from fvt_tpu_torch.models.from_jax import vggish_state_from_flax
from fvt_tpu_torch.models.vggish import VGGish
from fvt_tpu_torch.preprocess import audio, melspec

SR = 16000
FPS = 30.0
EMBED_RTOL = 1e-4
HALF_FLIPS = 2e-3


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread_x64_off():
    """One torch intra-op thread (the suite's workers share the cores) and
    fvt_tpu in float32: x64 off for the file, restored after it."""
    n = torch.get_num_threads()
    was_x64 = bool(jax.config.jax_enable_x64)
    torch.set_num_threads(1)
    jax.config.update('jax_enable_x64', False)
    yield
    jax.config.update('jax_enable_x64', was_x64)
    torch.set_num_threads(n)


def _wav(path, seconds: float, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    x = 0.2 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.normal(size=n)
    x[n // 2:n // 2 + n // 8] = 0  # a stretch of silence
    melspec.write_wav(str(path), (x * 32767).astype(np.int16), SR)
    return str(path)


@pytest.fixture(scope='module')
def vggish():
    """fvt_tpu's VGGish params drawn with numpy by leaf name (kernels
    scaled by their fan-in) and the port's VGGish carrying them."""
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


ANNOTATED = {'none': None,
             'inside': np.array([0, 3, 3, 7, 1]),
             'past-the-end': np.arange(0, 60, 2)}


@pytest.mark.parametrize('which', list(ANNOTATED))
def test_extract_logmel_within_one_float16_ulp(tmp_path, which):
    wav = _wav(tmp_path / 'clip.wav', 1.3)
    idx = ANNOTATED[which]
    want_path, got_path = tmp_path / 'want.npy', tmp_path / 'got.npy'
    jax_audio.extract_logmel(wav, str(want_path), hop_sec=1 / FPS,
                             annotated_idx=idx)
    audio.extract_logmel(wav, str(got_path), hop_sec=1 / FPS,
                         annotated_idx=idx, device='cpu')
    want, got = np.load(want_path), np.load(got_path)
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape
    if idx is not None:
        assert len(got) == len(idx)
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(got)))
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (diff <= ulp).all()
    assert np.count_nonzero(diff) <= HALF_FLIPS * diff.size


def test_extract_logmel_keeps_an_existing_file(tmp_path):
    out = tmp_path / 'logmel.npy'
    np.save(out, np.zeros(3))
    audio.extract_logmel(_wav(tmp_path / 'clip.wav', 1.0), str(out),
                         device='cpu')
    assert np.array_equal(np.load(out), np.zeros(3))


@pytest.mark.parametrize('which', ['none', 'past-the-end'])
def test_extract_vggish_embeddings_matches_fvt_tpu(tmp_path, vggish, which):
    params, model = vggish
    wav = _wav(tmp_path / 'clip.wav', 1.0, seed=1)
    idx = ANNOTATED[which]
    want = jax_audio.extract_vggish_embeddings(
        wav, params, 0.96, 1 / FPS, input_size=8, annotated_idx=idx)
    got = audio.extract_vggish_embeddings(
        wav, model, 0.96, 1 / FPS, input_size=8, annotated_idx=idx,
        device='cpu')
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= EMBED_RTOL * np.abs(want).max()

    patches = melspec.wavfile_to_examples(wav, 0.96, 1 / FPS, device='cpu')
    assert len(patches) == 31
    with torch.inference_mode():
        rows = model(torch.from_numpy(patches)).numpy()
    if idx is None:
        assert len(got) == 30
        np.testing.assert_allclose(got, rows[1:], rtol=0, atol=1e-6)
    else:  # gathered at idx from the shifted rows, the last repeated
        np.testing.assert_allclose(got, rows[1:][np.minimum(idx, 29)],
                                   rtol=0, atol=1e-6)


def test_extract_vggish_embeddings_of_one_patch_is_zeros(tmp_path, vggish):
    params, model = vggish
    wav = str(tmp_path / 'empty.wav')
    melspec.write_wav(wav, np.zeros(0, np.int16), SR)
    idx = np.array([0, 4, 2])
    want = jax_audio.extract_vggish_embeddings(
        wav, params, 0.96, 1 / FPS, input_size=8, annotated_idx=idx)
    got = audio.extract_vggish_embeddings(
        wav, model, 0.96, 1 / FPS, input_size=8, annotated_idx=idx,
        device='cpu')
    assert got.shape == want.shape == (3, 128)
    assert got.dtype == want.dtype
    assert not got.any() and not want.any()


def test_vggish_from_pth_and_its_device(tmp_path, vggish):
    _, model = vggish
    pth = str(tmp_path / 'vggish.pth')
    torch.save(model.state_dict(), pth)
    loaded = audio.vggish_from_pth(pth, device='cpu')
    assert not loaded.training
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    with pytest.raises(ValueError, match='put it there once'):
        audio.extract_vggish_embeddings(
            _wav(tmp_path / 'clip.wav', 0.2), model, 0.96, 1 / FPS,
            device='meta')


@pytest.mark.parametrize('entry', [
    'log_mel_spectrogram', 'waveform_to_examples', 'wavfile_to_examples',
    'extract_logmel', 'extract_vggish_embeddings', 'vggish_from_pth'])
def test_entry_points_need_the_card_by_default(tmp_path, monkeypatch,
                                               entry):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    wav = _wav(tmp_path / 'clip.wav', 0.2)
    out = tmp_path / 'out.npy'
    calls = {
        'log_mel_spectrogram': lambda: melspec.log_mel_spectrogram(
            np.zeros(SR)),
        'waveform_to_examples': lambda: melspec.waveform_to_examples(
            np.zeros(SR), SR, 0.96, 1 / FPS),
        'wavfile_to_examples': lambda: melspec.wavfile_to_examples(
            wav, 0.96, 1 / FPS),
        'extract_logmel': lambda: audio.extract_logmel(wav, str(out)),
        'extract_vggish_embeddings': lambda: audio.extract_vggish_embeddings(
            wav, VGGish(), 0.96, 1 / FPS),
        'vggish_from_pth': lambda: audio.vggish_from_pth(str(out))}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        calls[entry]()
    assert not out.exists()
