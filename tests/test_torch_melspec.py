"""The port's log-mel frontend (``fvt_tpu_torch/preprocess/melspec.py``)
against ``fvt_tpu``'s on the CPU, on seeded numpy waveforms.

``fvt_tpu``'s STFT runs in float32 with ``jax_enable_x64`` off (as it
runs in production: ``jnp.asarray`` rounds its float64 frames to
float32); the fixture switches x64 off for this file, asserts it, and
restores it.  The port's transform runs in float64 on the same float32
windowed frames, so the two differ by ``fvt_tpu``'s float32 FFT error:

* the log-mel within 1e-5 absolute of ``fvt_tpu``'s, on noise at lengths
  below one frame, below one of ``fvt_tpu``'s 512-row buckets and above
  it, and within 1e-6 of a float64 numpy log-mel on a tone with a
  constant tail, where a float32 transform is ~2e-4 off;
* the mel matrix, the Hann window and the example framing at 29.97, 30
  and 25 fps exactly equal, on numpy and on tensors;
* ``waveform_to_examples`` on 44.1 kHz stereo and ``wavfile_to_examples``
  on an empty wav and a 0.5 s one: the same shapes and dtypes, the
  values within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from fvt_tpu.preprocess import melspec as jax_melspec
from fvt_tpu_torch.preprocess import melspec

SR = 16000
LOG_MEL_ATOL = 1e-5
REFERENCE_ATOL = 1e-6


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


def _noise(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=n) * 0.1


@pytest.mark.parametrize('n', [300, 5000, 100_000],
                         ids=['below-a-frame', 'below-a-bucket',
                              'above-a-bucket'])
def test_log_mel_spectrogram_matches_fvt_tpu(n):
    assert not jax.config.jax_enable_x64
    wav = _noise(n)
    want = jax_melspec.log_mel_spectrogram(wav)
    got = melspec.log_mel_spectrogram(wav, device='cpu')
    assert got.shape == want.shape and got.dtype == want.dtype
    assert want.dtype == (np.float32 if n >= 400 else np.float64)
    if n > 512 * 160:
        assert len(got) > 512  # past fvt_tpu's first bucket
    if got.size:
        assert np.abs(got - want).max() <= LOG_MEL_ATOL


def _windowed(wav: np.ndarray) -> np.ndarray:
    """The float32-rounded waveform's frames times the Hann window."""
    w = np.asarray(wav, np.float64).astype(np.float32)
    idx = (np.arange(1 + (len(w) - 400) // 160)[:, None] * 160
           + np.arange(400))
    return w[idx] * melspec.periodic_hann(400).astype(np.float32)


def _float64_log_mel(wav: np.ndarray) -> np.ndarray:
    """The log-mel of the float32 windowed frames in float64 numpy."""
    mag = np.abs(np.fft.rfft(_windowed(wav).astype(np.float64), 512))
    mel = mag @ melspec.spectrogram_to_mel_matrix(64, 257, SR, 125, 7500)
    return np.log(mel + 0.01)


@pytest.mark.parametrize('signal', ['tone-then-constant', 'noise'])
def test_log_mel_transform_is_float64(signal):
    t = np.arange(SR) / SR
    wav = (np.concatenate([0.5 * np.sin(2 * np.pi * 440 * t),
                           np.full(SR, 0.3)])
           if signal == 'tone-then-constant' else _noise(3 * SR, 1))
    got = melspec.log_mel_spectrogram(wav, device='cpu')
    want = _float64_log_mel(wav)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= REFERENCE_ATOL
    if signal == 'tone-then-constant':
        # why float64: the same chain with a float32 transform is ~2e-4
        # off in the tone's quiet bands, beyond the 1e-5 card-vs-host gate
        mag = torch.fft.rfft(torch.from_numpy(_windowed(wav)), n=512).abs()
        mel = mag @ torch.from_numpy(melspec.spectrogram_to_mel_matrix(
            64, 257, SR, 125, 7500)).float()
        float32 = torch.log(mel + 0.01).numpy()
        assert np.abs(float32 - want).max() > 10 * LOG_MEL_ATOL


def test_constants_and_tables_are_equal():
    for name in ('SAMPLE_RATE', 'STFT_WINDOW_LENGTH_SECONDS',
                 'STFT_HOP_LENGTH_SECONDS', 'NUM_MEL_BINS', 'MEL_MIN_HZ',
                 'MEL_MAX_HZ', 'LOG_OFFSET', 'EXAMPLE_WINDOW_SECONDS',
                 '_MEL_BREAK_FREQUENCY_HERTZ', '_MEL_HIGH_FREQUENCY_Q'):
        assert getattr(melspec, name) == getattr(jax_melspec, name), name
    for window in (400, 401, 1024):
        assert np.array_equal(melspec.periodic_hann(window),
                              jax_melspec.periodic_hann(window))
    for kw in ({'num_mel_bins': 64, 'num_spectrogram_bins': 257,
                'audio_sample_rate': SR, 'lower_edge_hertz': 125,
                'upper_edge_hertz': 7500}, {}):
        assert np.array_equal(melspec.spectrogram_to_mel_matrix(**kw),
                              jax_melspec.spectrogram_to_mel_matrix(**kw))
    hz = np.linspace(0, 8000, 97)
    assert np.array_equal(melspec.hertz_to_mel(hz),
                          jax_melspec.hertz_to_mel(hz))


@pytest.mark.parametrize('fps', [29.97, 30.0, 25.0])
@pytest.mark.parametrize('rows', [1000, 95])
def test_frame_examples_fractional_equal(fps, rows):
    log_mel = np.random.default_rng(2).normal(size=(rows, 64)).astype(
        np.float32)
    hop = (1.0 / fps) * 100.0
    want = jax_melspec.frame_examples_fractional(log_mel, 96, hop)
    got = melspec.frame_examples_fractional(log_mel, 96, hop)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    on_tensor = melspec.frame_examples_fractional(
        torch.from_numpy(log_mel), 96, hop)
    assert np.array_equal(on_tensor.numpy(), want)


def test_waveform_to_examples_stereo_44k():
    sr = 44100
    wav = np.random.default_rng(3).normal(size=(int(1.5 * sr), 2)) * 0.1
    want = jax_melspec.waveform_to_examples(wav, sr, 0.96, 1 / 30)
    got = melspec.waveform_to_examples(wav, sr, 0.96, 1 / 30, device='cpu')
    assert got.shape == want.shape == (16, 96, 64)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= LOG_MEL_ATOL


@pytest.mark.parametrize('seconds', [0.0, 0.5])
def test_wavfile_to_examples(tmp_path, seconds):
    n = int(seconds * SR)
    data = (np.random.default_rng(4).normal(size=n) * 3000).astype(np.int16)
    path = str(tmp_path / 'clip.wav')
    melspec.write_wav(path, data, SR)
    read, sr = melspec.read_wav(path)
    assert sr == SR and np.array_equal(read, data)
    want = jax_melspec.wavfile_to_examples(path, 0.96, 1 / 25)
    got = melspec.wavfile_to_examples(path, 0.96, 1 / 25, device='cpu')
    assert got.shape == want.shape and got.dtype == want.dtype
    assert len(got) == (1 if n == 0 else 14)
    assert np.abs(got - want).max() <= LOG_MEL_ATOL
