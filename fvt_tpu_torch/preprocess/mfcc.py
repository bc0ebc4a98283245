"""MFCC extraction (39-d): the reference's openSMILE HTK-MFCC chain,
implemented natively component-by-component.  A copy of
``fvt_tpu/preprocess/mfcc.py`` that runs on the host in float64 numpy, as
there, held equal to it by ``tests/test_torch_copies.py``.

The reference extracts MFCC with openSMILE (base/audio.py:73-96) using
the bundled config ``abaw5_pre_processing/load/opensmile_mfcc.conf``
("HTK target kind: MFCC_0_D_A, numCeps=12") with frameSize/frameStep
rewritten at runtime to (window_sec, 1/target_fps).  That config is a
fully-specified pipeline; :func:`mfcc` here implements each component
with the exact semantics the config selects:

    cFramer             frameMode=fixed, frameCenterSpecial=left,
                        noPostEOIprocessing=1  -> frames start at
                        i*round(hop*sr), length round(window*sr); only
                        COMPLETE frames are emitted.  openSMILE steps by
                        an integer number of samples, so a fractional
                        hop (1/fps) accumulates drift exactly like the
                        reference run does (unlike the vggish my_frame
                        path, which carries the fractional remainder).
    cVectorPreemphasis  k=0.97, de=0 -> HTK per-frame pre-emphasis:
                        x[n] -= k*x[n-1] (n=N-1..1), x[0] *= (1-k).
    cWindower           Hamming, 0.54 - 0.46*cos(2*pi*n/(N-1)).
    cTransformFFT       zeroPadSymmetric=0 -> zero-pad at the END to the
                        next power of two; unnormalised DFT.
    cFFTmagphase        magnitude spectrum (N/2+1 bins).
    cMelspec            htkcompatible=1, usePower=1, nBands=26,
                        lofreq=0, hifreq=8000, specScale=mel ->
                        magnitudes scaled by 32767 (HTK int16 sample
                        convention), squared, then 26 triangular filters
                        with boundary points equally spaced in
                        mel(f) = 1127*ln(1+f/700), filter weights linear
                        IN MEL (HTK convention), peak 1, un-normalised.
    cMfcc               firstMfcc=0, lastMfcc=12, cepLifter=22,
                        htkcompatible=1 -> mel floor 1.0 (HTK MELFLOOR),
                        natural log, HTK DCT-II
                        c_i = sqrt(2/26) * sum_j m_j cos(pi*i*(j+.5)/26)
                        (same sqrt(2/N) scale for ALL i, including c0),
                        liftering c_i *= 1 + 11*sin(pi*i/22), and HTK
                        output order c1..c12 then c0 appended last.
    cDeltaRegression x2 deltawin=2 -> HTK regression deltas
                        d[t] = sum_i i*(x[t+i]-x[t-i]) / (2*sum_i i^2)
                        with edge frames replicated (the HTK boundary
                        rule the component documents itself against).
    cVectorConcat       [c1..c12,c0, deltas, delta-deltas] = 39 columns,
                        matching the csv columns 3..41 that
                        base/preprocessing.py:845-859 compacts to
                        mfcc.npy.

Verification status: without the ``opensmile`` package at hand,
bit-exactness against the binary cannot be asserted here; every
component above follows the published openSMILE/HTK semantics for the
exact options in the conf file, and the suite pins the chain's
analytically-known outputs (silence -> exactly zero, framing counts,
DCT/lifter closed forms, delta edge rule).  One knowingly-ambiguous
constant: openSMILE scales by 32767.0 where HTK's int16 convention
suggests 32768; a uniform scale s shifts only c0 by ln(s^2)*sqrt(2/26)
(DCT of a constant), i.e. a <=4e-5 absolute c0 delta between the two.

eGeMAPS functionals use openSMILE when it is importable (canonical
numerics) and otherwise the NATIVE spec-conformant eGeMAPSv02 in
``preprocess/egemaps.py`` (all 25 LLDs + 88 functionals in opensmile's
column order; approximations documented there).  Neither modality is in
the reference's default feature set (vggish/bert/video;
project/abaw5/configs.py:143 gates mfcc to 0).
"""
from __future__ import annotations

import numpy as np

from fvt_tpu_torch.preprocess import melspec

SAMPLE_SCALE = 32767.0  # cMelspec htkcompatible sample-value scaling
MEL_FLOOR = 1.0         # HTK MELFLOOR (cMfcc htkcompatible=1)
N_BANDS = 26
N_CEPS = 13             # c0..c12
CEP_LIFTER = 22.0
PREEMPH_K = 0.97


def _hz_to_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _frame_signal(wav: np.ndarray, size: int, step: int) -> np.ndarray:
    """cFramer frameMode=fixed/left/noPostEOI: complete frames only."""
    n = (len(wav) - size) // step + 1 if len(wav) >= size else 0
    if n <= 0:
        return np.zeros((0, size), dtype=np.float64)
    idx = np.arange(size)[None, :] + step * np.arange(n)[:, None]
    return wav[idx].astype(np.float64)


def _preemphasis_htk(frames: np.ndarray, k: float = PREEMPH_K):
    """HTK per-frame pre-emphasis (cVectorPreemphasis de=0)."""
    out = frames.copy()
    out[:, 1:] -= k * frames[:, :-1]
    out[:, 0] *= (1.0 - k)
    return out


def _mel_filterbank(n_fft: int, sr: int, n_bands: int = N_BANDS,
                    lo_hz: float = 0.0, hi_hz: float = 8000.0):
    """(n_fft//2+1, n_bands) HTK triangular filters, linear in mel."""
    bins_hz = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    bins_mel = _hz_to_mel(bins_hz)
    bounds = np.linspace(_hz_to_mel(lo_hz), _hz_to_mel(hi_hz),
                         n_bands + 2)
    lower, center, upper = bounds[:-2], bounds[1:-1], bounds[2:]
    up = ((bins_mel[:, None] - lower) / (center - lower))
    down = ((upper - bins_mel[:, None]) / (upper - center))
    fb = np.maximum(0.0, np.minimum(up, down))
    fb[bins_mel > bounds[-1], :] = 0.0
    return fb


def _dct_htk(log_mel: np.ndarray, n_ceps: int = N_CEPS) -> np.ndarray:
    """HTK DCT-II: sqrt(2/N) scale for every coefficient incl. c0."""
    n = log_mel.shape[1]
    j = np.arange(n)
    basis = np.cos(np.pi * np.arange(n_ceps)[:, None] * (j + 0.5) / n)
    return log_mel @ (np.sqrt(2.0 / n) * basis.T)


def _lifter(cep: np.ndarray, L: float = CEP_LIFTER) -> np.ndarray:
    i = np.arange(cep.shape[1])
    return cep * (1.0 + (L / 2.0) * np.sin(np.pi * i / L))


def _delta(feat: np.ndarray, width: int = 2) -> np.ndarray:
    """HTK regression deltas over +-width frames, edges replicated."""
    n = feat.shape[0]
    denom = 2 * sum(i * i for i in range(1, width + 1))
    padded = np.pad(feat, ((width, width), (0, 0)), mode='edge')
    out = np.zeros_like(feat)
    for i in range(1, width + 1):
        out += i * (padded[width + i:width + i + n]
                    - padded[width - i:width - i + n])
    return out / denom


def mfcc(wav: np.ndarray, sample_rate: int = 16000,
         window_sec: float = 0.025,
         hop_sec: float = 0.010) -> np.ndarray:
    """(num_frames, 39) float32 in openSMILE HTK order:
    [c1..c12, c0, deltas, delta-deltas].

    ``wav`` is float in [-1, 1) (the opensmile python wrapper's soundfile
    convention); ``hop_sec`` is what the reference rewrites into the conf
    (1/target_fps — base/preprocessing.py:830-834)."""
    wav = np.asarray(wav, dtype=np.float64)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    size = int(round(window_sec * sample_rate))
    step = max(1, int(round(hop_sec * sample_rate)))
    frames = _frame_signal(wav, size, step)
    if frames.shape[0] == 0:
        return np.zeros((0, 3 * N_CEPS), dtype=np.float32)

    frames = _preemphasis_htk(frames)
    win = 0.54 - 0.46 * np.cos(
        2.0 * np.pi * np.arange(size) / (size - 1))
    frames = frames * win

    n_fft = 1
    while n_fft < size:
        n_fft *= 2
    mag = np.abs(np.fft.rfft(frames, n=n_fft, axis=1))
    power = (mag * SAMPLE_SCALE) ** 2

    fb = _mel_filterbank(n_fft, sample_rate)
    mel = power @ fb
    log_mel = np.log(np.maximum(mel, MEL_FLOOR))

    cep = _lifter(_dct_htk(log_mel))
    static = np.concatenate([cep[:, 1:], cep[:, :1]], axis=1)  # HTK order
    d1 = _delta(static)
    d2 = _delta(d1)
    return np.concatenate([static, d1, d2], axis=1).astype(np.float32)


def extract_mfcc(wav_path: str, output_path: str,
                 annotated_idx: np.ndarray = None,
                 hop_sec: float = 0.010):
    """wav file -> mfcc.npy (resampled to the annotated frame index when
    given, matching the compact_audio_feature contract of
    base/preprocessing.py:992-1018: edge-pad then gather)."""
    import os
    if os.path.isfile(output_path):
        return
    data, sr = melspec.read_wav(wav_path)
    samples = data / 32768.0
    if samples.ndim > 1:  # stereo wav -> mono, like waveform_to_examples
        samples = np.mean(samples, axis=1)
    feats = mfcc(samples, sample_rate=sr, hop_sec=hop_sec)
    feats = np.nan_to_num(feats)
    if annotated_idx is not None:
        # ONE implementation of the compact_audio_feature edge-pad
        # contract (incl. the empty-matrix degradation) for every
        # compacted audio feature
        from fvt_tpu_torch.preprocess.audio import _pad_to_annotated
        feats = _pad_to_annotated(feats, annotated_idx)[annotated_idx]
    os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                exist_ok=True)
    np.save(output_path, feats)


def extract_egemaps(wav_path: str, output_path: str,
                    length: int = None, target_frequency: float = None,
                    annotated_idx: np.ndarray = None,
                    target_frequence: float = None):
    """eGeMAPSv02 FUNCTIONALS (88-d), one vector per target frame over a
    1-second sliding window — the reference's exact windowing scheme
    (base/audio.py:99-117: starts = arange(length)/fps, ends = starts+1,
    one row per VIDEO frame), then gathered at ``annotated_idx`` like
    every compacted audio feature (base/preprocessing.py:879-891).

    Uses the openSMILE package when importable (its implementation
    DEFINES the canonical numerics); otherwise falls back to the native
    spec-conformant implementation in preprocess/egemaps.py (same 88
    columns, same order, openSMILE-independent numerics — the module
    docstring records every approximation).  Stores produced with one
    backend should not be mixed with the other."""
    import os
    if target_frequency is None:
        # the reference API's own spelling (base/audio.py:99 names the
        # parameter 'target_frequence'); accepted as an alias so callers
        # porting reference code don't silently lose the per-frame path.
        # No **kwargs: any OTHER misspelling raises TypeError instead of
        # silently writing a (1, 88) whole-file matrix
        target_frequency = target_frequence
    if os.path.isfile(output_path):
        return
    try:
        import opensmile
    except ImportError:
        opensmile = None
    if opensmile is None:
        from fvt_tpu_torch.preprocess import egemaps as native
        data, sr = melspec.read_wav(wav_path)
        samples = data / 32768.0
        if samples.ndim > 1:
            samples = np.mean(samples, axis=1)
        if length is not None and target_frequency is not None:
            feats = native.egemaps_per_frame(samples, sr, int(length),
                                             target_frequency)
        else:
            feats = native.egemaps_functionals(samples, sr)[None]
    else:
        smile = opensmile.Smile(
            feature_set=opensmile.FeatureSet.eGeMAPSv02,
            feature_level=opensmile.FeatureLevel.Functionals)
        if length is not None and target_frequency is not None:
            starts = np.arange(length) / target_frequency
            ends = starts + 1.0
            feats = smile.process_files(
                files=[wav_path] * int(length), starts=starts,
                ends=ends).values
        else:
            feats = smile.process_file(wav_path).values
    feats = np.nan_to_num(np.asarray(feats, dtype=np.float32))
    if annotated_idx is not None:
        # compact_audio_feature contract: edge-pad so every annotated
        # index exists, then gather (base/preprocessing.py:992-1018) —
        # shared with logmel/vggish/mfcc (audio._pad_to_annotated)
        from fvt_tpu_torch.preprocess.audio import _pad_to_annotated
        feats = _pad_to_annotated(feats, annotated_idx)[annotated_idx]
    os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                exist_ok=True)
    np.save(output_path, feats)
