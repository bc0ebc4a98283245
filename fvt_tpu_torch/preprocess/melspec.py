"""Log-mel spectrogram frontend (VGGish flavour) on the card: the port of
``fvt_tpu/preprocess/melspec.py``.

Same semantics as the upstream vggish ``mel_features.py:21-236`` and
``vggish_input.py:38-83`` that ``fvt_tpu`` follows:

  * periodic Hann window, rfft magnitude STFT (25 ms / 10 ms @ 16 kHz,
    fft = next pow2 = 512);
  * HTK mel filterbank 64 bins over 125-7500 Hz, DC bin zeroed;
  * log(mel + 0.01);
  * example framing with FRACTIONAL hop (hop = 1/fps * 100 frames, start
    offsets rounded per example, ``my_frame`` semantics) so one 96x64
    patch lands per video frame.

The numpy helpers (``hertz_to_mel``, ``periodic_hann``,
``spectrogram_to_mel_matrix``, the ``vggish_params`` constants) are
``fvt_tpu``'s.  The STFT, which ``fvt_tpu`` runs as one jit of XLA ops in
float32, runs here as PyTorch ops on ``device``: the waveform is rounded
to float32 on the host (what ``jnp.asarray`` does to ``fvt_tpu``'s float64
frames with x64 off; rounding then framing gives the same numbers as
framing then rounding), uploaded once and framed on the device
(``unfold``), windowed in float32, ``torch.fft.rfft(n=512)`` and ``abs``
in float64 (see ``_log_mel``), ``@`` the (257, 64) mel matrix in float32
with TF32 off, ``log(x + 0.01)``.  The float64 transform puts the port
within ~3e-7 of the upstream float64 log-mel where ``fvt_tpu``'s float32
one is ~4e-6 off on noise and ~2e-4 on a pure tone.
``fvt_tpu``'s 512-row bucket padding, there only to spare ``jit`` a
recompile, has no counterpart.  The example framing keeps Python's
``round(hop * i)`` on the host and gathers the patches where the log-mel
lies.

The entry points take ``device=None`` to mean the card and raise where
there is none; the CPU is used only when the caller passes
``device='cpu'``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Union

import numpy as np
import torch

from fvt_tpu_torch.train.steps import resolve_device

# vggish_params.py:21-34
SAMPLE_RATE = 16000
STFT_WINDOW_LENGTH_SECONDS = 0.025
STFT_HOP_LENGTH_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125
MEL_MAX_HZ = 7500
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0

Array = Union[np.ndarray, torch.Tensor]


def hertz_to_mel(frequencies_hertz):
    return _MEL_HIGH_FREQUENCY_Q * np.log(
        1.0 + (frequencies_hertz / _MEL_BREAK_FREQUENCY_HERTZ))


def periodic_hann(window_length: int) -> np.ndarray:
    return 0.5 - (0.5 * np.cos(2 * np.pi / window_length
                               * np.arange(window_length)))


def spectrogram_to_mel_matrix(num_mel_bins=20, num_spectrogram_bins=129,
                              audio_sample_rate=8000,
                              lower_edge_hertz=125.0,
                              upper_edge_hertz=3800.0) -> np.ndarray:
    """(num_spectrogram_bins, num_mel_bins) HTK triangular filterbank."""
    nyquist = audio_sample_rate / 2.0
    assert 0.0 <= lower_edge_hertz < upper_edge_hertz <= nyquist
    bins_hz = np.linspace(0.0, nyquist, num_spectrogram_bins)
    bins_mel = hertz_to_mel(bins_hz)
    edges_mel = np.linspace(hertz_to_mel(lower_edge_hertz),
                            hertz_to_mel(upper_edge_hertz),
                            num_mel_bins + 2)
    lower = edges_mel[:-2][None, :]
    center = edges_mel[1:-1][None, :]
    upper = edges_mel[2:][None, :]
    lower_slope = (bins_mel[:, None] - lower) / (center - lower)
    upper_slope = (upper - bins_mel[:, None]) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0  # exclude DC
    return weights


@contextlib.contextmanager
def no_tf32():
    """Full float32 products and convolutions whatever the caller set,
    the caller's settings restored on the way out: fvt_tpu's are float32
    (TF32 would move the log-mel by ~1e-3, and the extractors' features
    as much)."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _log_mel(data: np.ndarray, device: torch.device,
             audio_sample_rate: int = SAMPLE_RATE,
             log_offset: float = LOG_OFFSET,
             window_length_secs: float = STFT_WINDOW_LENGTH_SECONDS,
             hop_length_secs: float = STFT_HOP_LENGTH_SECONDS,
             num_mel_bins: int = NUM_MEL_BINS,
             lower_edge_hertz: float = MEL_MIN_HZ,
             upper_edge_hertz: float = MEL_MAX_HZ) -> torch.Tensor:
    """(num_frames, num_mel_bins) float32 log-mel on ``device``; where the
    waveform holds no whole frame, (0, num_mel_bins) float64 zeros, as
    ``fvt_tpu`` returns."""
    window_length = int(round(audio_sample_rate * window_length_secs))
    hop_length = int(round(audio_sample_rate * hop_length_secs))
    fft_length = 2 ** int(np.ceil(np.log(window_length) / np.log(2.0)))

    num_frames = 1 + int(np.floor((len(data) - window_length) / hop_length))
    if num_frames <= 0:
        return torch.zeros((0, num_mel_bins), dtype=torch.float64,
                           device=device)
    samples = torch.from_numpy(
        np.asarray(data, dtype=np.float64).astype(np.float32)).to(device)
    window = torch.from_numpy(periodic_hann(window_length)).float()
    mel_matrix = torch.from_numpy(spectrogram_to_mel_matrix(
        num_mel_bins=num_mel_bins,
        num_spectrogram_bins=fft_length // 2 + 1,
        audio_sample_rate=audio_sample_rate,
        lower_edge_hertz=lower_edge_hertz,
        upper_edge_hertz=upper_edge_hertz)).float()

    frames = samples.unfold(0, window_length, hop_length)
    windowed = frames * window.to(device)
    # the transform in float64 on the float32 windowed frames (exact in
    # float64): a float32 FFT's error is relative to the frame's largest
    # bin, and log(mel + 0.01) carries it to the quiet bands of a tonal
    # frame a hundredfold, so two float32 FFT libraries' log-mels differ
    # there by up to ~2e-4.  In float64 the card's and the host's agree
    # to the float32 matmul's and log's rounding.
    mag = torch.fft.rfft(windowed.double(), n=fft_length).abs().float()
    with no_tf32():
        mel = mag @ mel_matrix.to(device)
    return torch.log(mel + log_offset)


def log_mel_spectrogram(data: np.ndarray,
                        audio_sample_rate: int = SAMPLE_RATE,
                        log_offset: float = LOG_OFFSET,
                        window_length_secs: float
                        = STFT_WINDOW_LENGTH_SECONDS,
                        hop_length_secs: float = STFT_HOP_LENGTH_SECONDS,
                        num_mel_bins: int = NUM_MEL_BINS,
                        lower_edge_hertz: float = MEL_MIN_HZ,
                        upper_edge_hertz: float = MEL_MAX_HZ,
                        device=None) -> np.ndarray:
    """1-D waveform -> (num_frames, num_mel_bins) log-mel, computed on
    ``device`` (None: the card) and returned as numpy."""
    return _log_mel(data, resolve_device(device), audio_sample_rate,
                    log_offset, window_length_secs, hop_length_secs,
                    num_mel_bins, lower_edge_hertz,
                    upper_edge_hertz).cpu().numpy()


def frame_examples_fractional(log_mel: Array, window_length: int,
                              hop_length: float) -> Array:
    """``my_frame`` semantics (mel_features.py:21-49): per-example start =
    round(hop * i); incomplete tail examples dropped.  A numpy log-mel
    gives numpy examples, a tensor gives a tensor on its device."""
    num_samples = log_mel.shape[0]
    num_frames = 1 + int(np.floor((num_samples - window_length) / hop_length))
    shape = (max(num_frames, 0), window_length) + tuple(log_mel.shape[1:])
    if num_frames <= 0:
        if isinstance(log_mel, torch.Tensor):
            return log_mel.new_zeros(shape)
        return np.zeros(shape, log_mel.dtype)
    starts = np.array([round(hop_length * i) for i in range(num_frames)])
    idx = starts[:, None] + np.arange(window_length)[None, :]
    if isinstance(log_mel, torch.Tensor):
        return log_mel[torch.from_numpy(idx).to(log_mel.device)]
    return log_mel[idx]


def _examples(data: np.ndarray, sample_rate: int, window_sec: float,
              hop_sec: float, device: torch.device) -> torch.Tensor:
    """``waveform_to_examples``' patches as a tensor on ``device``."""
    if data.ndim > 1:
        data = np.mean(data, axis=1)
    if sample_rate != SAMPLE_RATE:
        data = resample(data, sample_rate, SAMPLE_RATE)

    log_mel = _log_mel(data, device)

    features_sample_rate = 1.0 / STFT_HOP_LENGTH_SECONDS
    example_window_length = int(round(window_sec * features_sample_rate))
    example_hop_length = hop_sec * features_sample_rate  # fractional!
    return frame_examples_fractional(log_mel, example_window_length,
                                     example_hop_length)


def waveform_to_examples(data: np.ndarray, sample_rate: int,
                         window_sec: float, hop_sec: float,
                         device=None) -> np.ndarray:
    """(num_examples, 96, 64) VGGish input patches
    (vggish_input.py:38-83).  hop_sec is typically 1/fps."""
    return _examples(data, sample_rate, window_sec, hop_sec,
                     resolve_device(device)).cpu().numpy()


def resample(data: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (replaces resampy)."""
    from scipy.signal import resample_poly
    g = math.gcd(sr_in, sr_out)
    return resample_poly(data, sr_out // g, sr_in // g)


def read_wav(path: str):
    """16-bit PCM WAV reader via stdlib (replaces soundfile)."""
    import wave
    with wave.open(path, 'rb') as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    assert width == 2, f'expected 16-bit PCM, got width={width}'
    data = np.frombuffer(raw, dtype=np.int16)
    if ch > 1:
        data = data.reshape(-1, ch)
    return data, sr


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """:func:`read_wav`'s inverse: int16 samples, (n,) or (n, channels),
    as a 16-bit PCM WAV."""
    import wave
    if data.dtype != np.int16:
        raise TypeError(f'16-bit PCM takes int16 samples, not {data.dtype}')
    with wave.open(path, 'wb') as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(data.tobytes())


def _wavfile_examples(wav_file: str, window_sec: float, hop_sec: float,
                      device: torch.device) -> torch.Tensor:
    """``wavfile_to_examples``' patches as a tensor on ``device``."""
    data, sr = read_wav(wav_file)
    samples = data / 32768.0
    # the reference edge-pads ONE SECOND of samples before framing
    # (vggish_input.py:97): without it the tail patches diverge and a
    # clip shorter than the window yields zero patches.  A truly empty
    # wav cannot be edge-padded (np.pad 'edge' on an empty axis raises);
    # it is padded with silence instead, so the zero-patch degradation
    # path in audio._pad_to_annotated is reachable rather than a
    # ValueError.
    pad = ((0, sr),) + ((0, 0),) * (samples.ndim - 1)
    mode = 'edge' if samples.shape[0] else 'constant'
    samples = np.pad(samples, pad, mode)
    return _examples(samples, sr, window_sec, hop_sec, device)


def wavfile_to_examples(wav_file: str, window_sec: float, hop_sec: float,
                        device=None) -> np.ndarray:
    return _wavfile_examples(wav_file, window_sec, hop_sec,
                             resolve_device(device)).cpu().numpy()
