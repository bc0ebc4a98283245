"""Native eGeMAPSv02 acoustic functionals (88-d), openSMILE-free: a copy
of ``fvt_tpu/preprocess/egemaps.py`` on the host in float64 numpy, held
equal to it by ``tests/test_torch_copies.py``.

The reference extracts eGeMAPS with the opensmile package
(the upstream base/audio.py:99-117: ``FeatureSet.eGeMAPSv02`` at
``FeatureLevel.Functionals`` over a 1-second sliding window per
annotated video frame, starts = arange(length)/fps, ends = starts+1).
This module implements the same 88-feature vector natively from the
published GeMAPS/eGeMAPS specification (Eyben et al., "The Geneva
Minimalistic Acoustic Parameter Set", IEEE Trans. Affective Computing
2016) so the modality works where opensmile is absent.

Status (same contract as the native MFCC chain in mfcc.py): column
COUNT, NAMES and ORDER match opensmile's eGeMAPSv02 csv exactly
(pinned in tests/test_egemaps.py); each feature follows the paper's
definition; NUMERICS are not bit-matched to the openSMILE binary —
its exact SHS pitch tracker, Zwicker loudness model and peak pickers
are implementation-defined.  ``extract_egemaps`` (mfcc.py) prefers the
opensmile package when importable and falls back to this module
otherwise.  Documented approximations:

  * F0: autocorrelation candidates + Viterbi octave-cost smoothing
    (openSMILE: subharmonic summation + Viterbi).  Range 55-1000 Hz,
    voicing threshold 0.45 on the normalized ACF peak, like the spec.
  * jitter/shimmer: per-period measurements from ACF-guided glottal
    cycle peak picking inside each voiced 60 ms frame (openSMILE uses
    its own waveform period matcher).
  * loudness: sum over 26 triangular auditory bands (20-8000 Hz) of
    band-power^0.3 (Stevens' law exponent the paper cites), not the
    full Zwicker model.
  * LLDs are computed ONCE for the whole file at 100 Hz and the
    per-video-frame functionals are taken over sliding 1 s slices of
    those tracks; openSMILE re-runs the LLD chain inside every window,
    which differs only at window boundaries.

LLD layout (25 tracks, 10 ms hop): 20 ms Hamming frames for spectral
descriptors, 60 ms frames for F0/HNR/jitter/shimmer; `sma3` = 3-frame
moving average; `nz` variants smooth and aggregate over voiced frames
only.  Smoothing runs ONCE over each whole LLD track (openSMILE's
cContourSmoother placement) before any functional.  All functionals are
finite by construction: empty voiced sets yield 0.0 (openSMILE's
undefined-value convention), never NaN.

Throughput (1-core host, 60 s of 16 kHz audio, 1500 video frames):
the LLD chain is batched numpy (one einsum per autocorrelation lag,
Levinson across all frames at once, ONE batched eigvals over the LPC
companion matrices) and the per-frame functionals ride masked
cumulative sums + strided percentile views (functionals_rows) — 652
frames/s all-in vs 117 for the per-row/per-frame loops they replaced
(5.6x; golden-checked to 6e-11 relative against the loop forms).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from fvt_tpu_torch.preprocess.mfcc import (_frame_signal, _mel_filterbank,
                                           _dct_htk, _lifter)

LLD_HOP_SEC = 0.010
SPEC_WIN_SEC = 0.020
PITCH_WIN_SEC = 0.060
F0_MIN, F0_MAX = 55.0, 1000.0
VOICING_THRESHOLD = 0.45
SEMITONE_BASE_HZ = 27.5

# The 88 output columns, in opensmile's eGeMAPSv02 Functionals csv order.
COLUMNS = [
    'F0semitoneFrom27.5Hz_sma3nz_amean',
    'F0semitoneFrom27.5Hz_sma3nz_stddevNorm',
    'F0semitoneFrom27.5Hz_sma3nz_percentile20.0',
    'F0semitoneFrom27.5Hz_sma3nz_percentile50.0',
    'F0semitoneFrom27.5Hz_sma3nz_percentile80.0',
    'F0semitoneFrom27.5Hz_sma3nz_pctlrange0-2',
    'F0semitoneFrom27.5Hz_sma3nz_meanRisingSlope',
    'F0semitoneFrom27.5Hz_sma3nz_stddevRisingSlope',
    'F0semitoneFrom27.5Hz_sma3nz_meanFallingSlope',
    'F0semitoneFrom27.5Hz_sma3nz_stddevFallingSlope',
    'loudness_sma3_amean',
    'loudness_sma3_stddevNorm',
    'loudness_sma3_percentile20.0',
    'loudness_sma3_percentile50.0',
    'loudness_sma3_percentile80.0',
    'loudness_sma3_pctlrange0-2',
    'loudness_sma3_meanRisingSlope',
    'loudness_sma3_stddevRisingSlope',
    'loudness_sma3_meanFallingSlope',
    'loudness_sma3_stddevFallingSlope',
    'spectralFlux_sma3_amean',
    'spectralFlux_sma3_stddevNorm',
    'mfcc1_sma3_amean',
    'mfcc1_sma3_stddevNorm',
    'mfcc2_sma3_amean',
    'mfcc2_sma3_stddevNorm',
    'mfcc3_sma3_amean',
    'mfcc3_sma3_stddevNorm',
    'mfcc4_sma3_amean',
    'mfcc4_sma3_stddevNorm',
    'jitterLocal_sma3nz_amean',
    'jitterLocal_sma3nz_stddevNorm',
    'shimmerLocaldB_sma3nz_amean',
    'shimmerLocaldB_sma3nz_stddevNorm',
    'HNRdBACF_sma3nz_amean',
    'HNRdBACF_sma3nz_stddevNorm',
    'logRelF0-H1-H2_sma3nz_amean',
    'logRelF0-H1-H2_sma3nz_stddevNorm',
    'logRelF0-H1-A3_sma3nz_amean',
    'logRelF0-H1-A3_sma3nz_stddevNorm',
    'F1frequency_sma3nz_amean',
    'F1frequency_sma3nz_stddevNorm',
    'F1bandwidth_sma3nz_amean',
    'F1bandwidth_sma3nz_stddevNorm',
    'F1amplitudeLogRelF0_sma3nz_amean',
    'F1amplitudeLogRelF0_sma3nz_stddevNorm',
    'F2frequency_sma3nz_amean',
    'F2frequency_sma3nz_stddevNorm',
    'F2bandwidth_sma3nz_amean',
    'F2bandwidth_sma3nz_stddevNorm',
    'F2amplitudeLogRelF0_sma3nz_amean',
    'F2amplitudeLogRelF0_sma3nz_stddevNorm',
    'F3frequency_sma3nz_amean',
    'F3frequency_sma3nz_stddevNorm',
    'F3bandwidth_sma3nz_amean',
    'F3bandwidth_sma3nz_stddevNorm',
    'F3amplitudeLogRelF0_sma3nz_amean',
    'F3amplitudeLogRelF0_sma3nz_stddevNorm',
    'alphaRatioV_sma3nz_amean',
    'alphaRatioV_sma3nz_stddevNorm',
    'hammarbergIndexV_sma3nz_amean',
    'hammarbergIndexV_sma3nz_stddevNorm',
    'slopeV0-500_sma3nz_amean',
    'slopeV0-500_sma3nz_stddevNorm',
    'slopeV500-1500_sma3nz_amean',
    'slopeV500-1500_sma3nz_stddevNorm',
    'spectralFluxV_sma3nz_amean',
    'spectralFluxV_sma3nz_stddevNorm',
    'mfcc1V_sma3nz_amean',
    'mfcc1V_sma3nz_stddevNorm',
    'mfcc2V_sma3nz_amean',
    'mfcc2V_sma3nz_stddevNorm',
    'mfcc3V_sma3nz_amean',
    'mfcc3V_sma3nz_stddevNorm',
    'mfcc4V_sma3nz_amean',
    'mfcc4V_sma3nz_stddevNorm',
    'alphaRatioUV_sma3nz_amean',
    'hammarbergIndexUV_sma3nz_amean',
    'slopeUV0-500_sma3nz_amean',
    'slopeUV500-1500_sma3nz_amean',
    'spectralFluxUV_sma3nz_amean',
    'loudnessPeaksPerSec',
    'VoicedSegmentsPerSec',
    'MeanVoicedSegmentLengthSec',
    'StddevVoicedSegmentLengthSec',
    'MeanUnvoicedSegmentLength',
    'StddevUnvoicedSegmentLength',
    'equivalentSoundLevel_dBp',
]
assert len(COLUMNS) == 88


# ------------------------------------------------------------------ pitch
def _window_acf(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hanning window, its floored normalized autocorrelation) — the
    Boersma-1993 taper compensation shared by the F0 tracker and the
    HNR estimator; one implementation so the 1e-3 floor cannot drift
    between voicing and HNR numerics."""
    win = np.hanning(size)
    wac = np.correlate(win, win, 'full')[size - 1:]
    return win, np.maximum(wac / wac[0], 1e-3)


def _f0_track(wav: np.ndarray, sr: int) -> Tuple[np.ndarray, np.ndarray]:
    """(f0_hz, voiced) per 10 ms frame from 60 ms analysis windows.

    Normalized-ACF candidates (top 5 peaks in the 55-1000 Hz lag range,
    parabolic lag interpolation) + Viterbi smoothing with an octave-jump
    transition cost — the spec's "Viterbi-based smoothing of the F0
    contour" over ACF rather than SHS candidates."""
    size = int(round(PITCH_WIN_SEC * sr))
    step = int(round(LLD_HOP_SEC * sr))
    frames = _frame_signal(wav, size, step)
    n = frames.shape[0]
    if n == 0:
        return np.zeros(0), np.zeros(0, bool)

    win, wac = _window_acf(size)
    fw = frames * win
    # FFT-based autocorrelation, normalized by lag-0
    nfft = 1
    while nfft < 2 * size:
        nfft *= 2
    spec = np.fft.rfft(fw, n=nfft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, axis=1)[:, :size]
    r0 = np.maximum(ac[:, 0], 1e-12)
    nacf = ac / r0[:, None]
    nacf = nacf / wac[None, :]

    lag_lo = max(2, int(sr / F0_MAX))
    lag_hi = min(size - 2, int(np.ceil(sr / F0_MIN)))
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    silence = rms < 5e-4

    body = nacf[:, lag_lo:lag_hi + 1]
    peaks = ((body[:, 1:-1] > body[:, :-2])
             & (body[:, 1:-1] >= body[:, 2:]))
    if peaks.shape[1] == 0:  # degenerate window: no interior lag fits
        return np.zeros(n), np.zeros(n, bool)
    K = min(5, peaks.shape[1])
    # octave cost (Praat-style): an ACF of a periodic signal peaks
    # equally at T0, 2*T0, 3*T0, ... — penalise longer periods so the
    # TRUE period wins over its subharmonics.  Vectorized top-K: score
    # every interior lag, mask non-peaks/silent frames to -inf, argsort.
    OCT_COST = 0.07
    lags_abs = np.arange(lag_lo + 1, lag_hi)  # interior lag positions
    oct_pen = OCT_COST * np.log2(lags_abs / lag_lo)
    score = np.where(peaks & ~silence[:, None],
                     nacf[:, lags_abs] - oct_pen[None, :], -np.inf)
    top = np.argsort(-score, axis=1)[:, :K]              # (n, K)
    valid = np.take_along_axis(score, top, axis=1) > -np.inf
    lag = lags_abs[top]
    y0 = np.take_along_axis(nacf, lag - 1, axis=1)
    y1 = np.take_along_axis(nacf, lag, axis=1)
    y2 = np.take_along_axis(nacf, lag + 1, axis=1)
    denom = y0 - 2 * y1 + y2
    d = np.where(np.abs(denom) > 1e-12,
                 0.5 * (y0 - y2) / np.where(np.abs(denom) > 1e-12,
                                            denom, 1.0), 0.0)
    d = np.clip(d, -0.5, 0.5)
    cand_f = np.where(valid, sr / (lag + d), 0.0)
    cand_s = np.where(valid,
                      np.minimum(y1, 1.0)
                      - OCT_COST * np.log2(lag / lag_lo), 0.0)

    # Viterbi: unvoiced is candidate K (strength = threshold), octave
    # jumps between voiced candidates are penalised per |log2 ratio|
    UNV = K
    strength = np.concatenate(
        [cand_s, np.full((n, 1), VOICING_THRESHOLD)], axis=1)
    freqs = np.concatenate([cand_f, np.zeros((n, 1))], axis=1)
    cost = -strength
    TRANS = 0.35
    dp = cost[0].copy()
    back = np.zeros((n, K + 1), np.int8)
    for t in range(1, n):
        fp, fc = freqs[t - 1], freqs[t]
        jump = np.zeros((K + 1, K + 1))
        vv = (fp[:, None] > 0) & (fc[None, :] > 0)
        with np.errstate(divide='ignore', invalid='ignore'):
            ratio = np.abs(np.log2(
                np.where(vv, fc[None, :] / np.maximum(fp[:, None], 1e-6),
                         1.0)))
        jump += TRANS * np.where(vv, ratio, 0.0)
        # voiced<->unvoiced switches cost a little, to avoid flicker
        jump += 0.14 * ((fp[:, None] > 0) != (fc[None, :] > 0))
        total = dp[:, None] + jump + cost[t][None, :]
        back[t] = np.argmin(total, axis=0)
        dp = total[back[t], np.arange(K + 1)]

    path = np.zeros(n, np.int64)
    path[-1] = int(np.argmin(dp))
    for t in range(n - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    f0 = freqs[np.arange(n), path]
    voiced = (path != UNV) & (f0 > 0)
    f0 = np.where(voiced, f0, 0.0)
    return f0, voiced


def _period_marks(frame: np.ndarray, t0: float) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Glottal-cycle peak positions and amplitudes inside one frame,
    walking ±T0 from the strongest peak with a ±T0/4 search window."""
    n = len(frame)
    a = np.abs(frame)
    start = int(np.argmax(a))
    half = max(1, int(round(t0 / 4)))
    pos = [start]
    p = start
    while True:  # forward
        c = p + int(round(t0))
        if c - half >= n:
            break
        lo, hi = max(0, c - half), min(n, c + half + 1)
        p = lo + int(np.argmax(a[lo:hi]))
        if p <= pos[-1]:
            break
        pos.append(p)
    p = start
    while True:  # backward
        c = p - int(round(t0))
        if c + half < 0:
            break
        lo, hi = max(0, c - half), min(n, c + half + 1)
        p = lo + int(np.argmax(a[lo:hi]))
        if p >= pos[0]:
            break
        pos.insert(0, p)
    pos = np.asarray(pos)
    return pos, a[pos]


def _jitter_shimmer_hnr(wav: np.ndarray, sr: int, f0: np.ndarray,
                        voiced: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame jitterLocal, shimmerLocaldB, HNRdBACF (0 when unvoiced
    or fewer than 3 cycles land in the 60 ms frame)."""
    size = int(round(PITCH_WIN_SEC * sr))
    step = int(round(LLD_HOP_SEC * sr))
    n = len(f0)
    jitter = np.zeros(n)
    shimmer = np.zeros(n)
    hnr = np.zeros(n)
    win, wac = _window_acf(size)
    vi = np.nonzero(voiced)[0]
    vi = vi[vi * step + size <= len(wav)]  # complete 60 ms segments only
    for t in vi:
        seg = wav[t * step:t * step + size]
        t0 = sr / f0[t]
        pos, amp = _period_marks(seg, t0)
        if len(pos) >= 3:
            periods = np.diff(pos).astype(np.float64)
            ok = amp[1:] > 1e-9
            jitter[t] = (np.abs(np.diff(periods)).mean()
                         / max(periods.mean(), 1e-9)) \
                if len(periods) >= 2 else 0.0
            if ok.all() and (amp[:-1] > 1e-9).all() and len(amp) >= 2:
                shimmer[t] = np.abs(
                    20.0 * np.log10(amp[1:] / amp[:-1])).mean()
    # HNR from the window-compensated normalized ACF at the T0 lag.
    # Only ac[0] and ac[lag] are needed — two O(size) dot products per
    # frame, batched: one einsum for all lag-0 energies, one einsum per
    # UNIQUE lag (voiced pitch clusters onto a handful of lags)
    if vi.size:
        segs = wav[vi[:, None] * step + np.arange(size)[None, :]] \
            * win[None, :]
        ac0 = np.maximum(np.einsum('nj,nj->n', segs, segs), 1e-12)
        lags = np.rint(sr / f0[vi]).astype(np.int64)
        ok = (lags >= 1) & (lags < size)
        for L in np.unique(lags[ok]):
            rows = np.nonzero(ok & (lags == L))[0]
            aclag = np.einsum('nj,nj->n', segs[rows, :size - L],
                              segs[rows, L:])
            p = np.clip((aclag / ac0[rows]) / wac[L], 1e-6, 1.0 - 1e-6)
            hnr[vi[rows]] = 10.0 * np.log10(p / (1.0 - p))
    return jitter, shimmer, hnr


# ------------------------------------------------------------- spectral
def _spectral_llds(wav: np.ndarray, sr: int) -> Dict[str, np.ndarray]:
    """20 ms-frame descriptors at 100 Hz: loudness, alphaRatio,
    hammarbergIndex, slope0-500/500-1500, spectralFlux, mfcc1-4."""
    size = int(round(SPEC_WIN_SEC * sr))
    step = int(round(LLD_HOP_SEC * sr))
    frames = _frame_signal(wav, size, step)
    n = frames.shape[0]
    nfft = 1
    while nfft < size:
        nfft *= 2
    win = np.hamming(size)
    mag = np.abs(np.fft.rfft(frames * win, n=nfft, axis=1))
    power = mag ** 2
    freqs = np.arange(nfft // 2 + 1) * (sr / nfft)

    out: Dict[str, np.ndarray] = {}

    # loudness: 26-band auditory spectrum, Stevens-law partial loudness
    fb = _mel_filterbank(nfft, sr, n_bands=26, lo_hz=20.0, hi_hz=8000.0)
    bands = np.maximum(power @ fb, 1e-12)
    out['loudness'] = (bands ** 0.3).sum(axis=1)

    def band(lo, hi):
        return (freqs >= lo) & (freqs < hi)

    e_50_1000 = power[:, band(50, 1000)].sum(axis=1)
    e_1k_5k = power[:, band(1000, 5000)].sum(axis=1)
    out['alphaRatio'] = 10.0 * np.log10(
        np.maximum(e_50_1000, 1e-12) / np.maximum(e_1k_5k, 1e-12))

    m_0_2k = power[:, band(0, 2000)].max(axis=1, initial=1e-12)
    m_2k_5k = power[:, band(2000, 5000)].max(axis=1, initial=1e-12)
    out['hammarbergIndex'] = 10.0 * np.log10(m_0_2k / m_2k_5k)

    def slope(lo, hi):
        sel = band(lo, hi)
        f = freqs[sel]
        y = 10.0 * np.log10(np.maximum(power[:, sel], 1e-12))
        fc = f - f.mean()
        return (y @ fc) / max((fc ** 2).sum(), 1e-12)

    out['slope0-500'] = slope(0, 500)
    out['slope500-1500'] = slope(500, 1500)

    # flux: mean squared difference of L2-normalised magnitude spectra
    mn = mag / np.maximum(
        np.linalg.norm(mag, axis=1, keepdims=True), 1e-12)
    flux = np.zeros(n)
    if n > 1:
        flux[1:] = ((mn[1:] - mn[:-1]) ** 2).sum(axis=1)
    out['spectralFlux'] = flux

    # MFCC 1-4 (26-band 20-8000 Hz, HTK DCT + liftering, as mfcc.py)
    log_mel = np.log(np.maximum((mag * 32767.0) ** 2 @ fb, 1.0))
    cep = _lifter(_dct_htk(log_mel, n_ceps=5))
    for i in range(1, 5):
        out[f'mfcc{i}'] = cep[:, i]

    out['_mag'] = mag
    out['_freqs'] = freqs
    return out


# ------------------------------------------------------------- formants
def _levinson_batch(r: np.ndarray) -> np.ndarray:
    """Levinson-Durbin over a batch: r (n, order+1) autocorrelations ->
    a (n, order+1) LPC polynomials (a[:, 0] == 1).  Per-frame semantics
    of the scalar recursion: k = 0 once e <= 1e-12, and the iteration
    STOPS for a frame whose prediction error hits e <= 0 (its remaining
    coefficients stay 0)."""
    n, o1 = r.shape
    order = o1 - 1
    a = np.zeros((n, order + 1))
    a[:, 0] = 1.0
    e = r[:, 0].copy()
    alive = np.ones(n, bool)
    for i in range(1, order + 1):
        acc = r[:, i] + np.einsum('nj,nj->n', a[:, 1:i],
                                  r[:, 1:i][:, ::-1])
        k = np.where(e > 1e-12, -acc / np.where(e > 1e-12, e, 1.0), 0.0)
        k = np.where(alive, k, 0.0)
        a[:, 1:i] += k[:, None] * a[:, 1:i][:, ::-1]
        a[:, i] = k
        e = np.where(alive, e * (1.0 - k * k), e)
        alive &= e > 0
    return a


def _formant_track(wav: np.ndarray, sr: int, lpc_order: int = 14
                   ) -> np.ndarray:
    """(n, 3, 2) [centre frequency, bandwidth] of F1-F3 per 10 ms frame
    via autocorrelation-method LPC root finding — fully batched: the
    per-lag autocorrelations are (order+1) einsum rows, Levinson runs
    across all frames at once, and the LPC roots come from ONE batched
    eigvals over the (n, order, order) companion matrices (np.roots'
    exact companion form; trailing-zero coefficients contribute zero
    eigenvalues, which the imag > 0.01 filter drops like np.roots'
    trimmed form would)."""
    size = int(round(SPEC_WIN_SEC * sr))
    step = int(round(LLD_HOP_SEC * sr))
    frames = _frame_signal(wav, size, step)
    n = frames.shape[0]
    out = np.zeros((n, 3, 2))
    if n == 0:
        return out
    pre = frames.copy()
    pre[:, 1:] -= 0.97 * frames[:, :-1]
    pre *= np.hamming(size)

    energetic = np.einsum('nj,nj->n', pre, pre) >= 1e-10
    r = np.stack([np.einsum('nj,nj->n', pre[:, :size - k], pre[:, k:])
                  if k else np.einsum('nj,nj->n', pre, pre)
                  for k in range(lpc_order + 1)], axis=1)
    a = _levinson_batch(r)

    comp = np.zeros((n, lpc_order, lpc_order))
    comp[:, np.arange(1, lpc_order), np.arange(lpc_order - 1)] = 1.0
    comp[:, 0, :] = -a[:, 1:]
    roots = np.linalg.eigvals(comp)  # (n, lpc_order) complex

    freq = np.angle(roots) * sr / (2.0 * np.pi)
    bw = -np.log(np.maximum(np.abs(roots), 1e-9)) * sr / np.pi
    keep = ((np.imag(roots) > 0.01) & (freq > 50.0) & (freq < 5500.0)
            & (bw < 1500.0) & energetic[:, None])
    fsort = np.where(keep, freq, np.inf)
    order_idx = np.argsort(fsort, axis=1)[:, :3]
    kept3 = np.take_along_axis(keep, order_idx, axis=1)
    out[:, :, 0] = np.where(kept3,
                            np.take_along_axis(freq, order_idx, axis=1),
                            0.0)
    out[:, :, 1] = np.where(kept3,
                            np.take_along_axis(bw, order_idx, axis=1),
                            0.0)
    return out


def _harmonic_mag(mag_row: np.ndarray, freqs: np.ndarray,
                  f: float, spacing: Optional[float] = None) -> float:
    """Magnitude of the harmonic nearest frequency f: the local bin
    maximum over ±1 bin around the nearest bin.  ``spacing`` (the
    harmonic spacing, i.e. f0) caps the search so two neighbouring
    harmonics can never share a picked bin — for low-pitched voices
    (f0 within ~2 FFT bins) an uncapped ±1-bin window would let H1 and
    H2 collapse onto the same maximum and zero out logRelF0-H1-H2."""
    if f <= 0 or f >= freqs[-1]:
        return 0.0
    df = float(freqs[1] - freqs[0])
    half = 1
    if spacing is not None and spacing / 2.0 <= df:
        half = 0  # neighbour's midpoint is inside ±1 bin: pin to nearest
    i = int(np.argmin(np.abs(freqs - f)))
    lo, hi = max(0, i - half), min(len(mag_row), i + half + 1)
    j = lo + int(np.argmax(mag_row[lo:hi]))
    return float(mag_row[j])


# ----------------------------------------------------------- LLD driver
def egemaps_lld(wav: np.ndarray, sr: int) -> Dict[str, np.ndarray]:
    """All 25 eGeMAPS LLD tracks at 100 Hz (unsmoothed), plus 'voiced'.

    ``wav`` float in [-1, 1).  Track lengths are truncated to the
    shortest chain (60 ms frames end earlier than 20 ms ones)."""
    wav = np.asarray(wav, dtype=np.float64)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)

    f0, voiced = _f0_track(wav, sr)
    jit, shim, hnr = _jitter_shimmer_hnr(wav, sr, f0, voiced)
    spec = _spectral_llds(wav, sr)
    formants = _formant_track(wav, sr)

    n = min(len(f0), len(spec['loudness']), len(formants))
    n = max(n, 0)
    f0, voiced = f0[:n], voiced[:n]
    mag, freqs = spec.pop('_mag')[:n], spec.pop('_freqs')

    lld: Dict[str, np.ndarray] = {
        k: np.asarray(v[:n]) for k, v in spec.items()}
    with np.errstate(divide='ignore'):
        semis = np.where(
            f0 > 0, 12.0 * np.log2(np.maximum(f0, 1e-6)
                                   / SEMITONE_BASE_HZ), 0.0)
    lld['F0semitone'] = semis
    lld['jitterLocal'] = jit[:n]
    lld['shimmerLocaldB'] = shim[:n]
    lld['HNRdBACF'] = hnr[:n]
    lld['voiced'] = voiced

    h1h2 = np.zeros(n)
    h1a3 = np.zeros(n)
    famp = np.zeros((n, 3))
    for t in np.nonzero(voiced)[0]:
        h1 = _harmonic_mag(mag[t], freqs, f0[t],
                           spacing=f0[t])
        h2 = _harmonic_mag(mag[t], freqs, 2.0 * f0[t],
                           spacing=f0[t])
        if h1 > 0 and h2 > 0:
            h1h2[t] = 20.0 * np.log10(h1 / h2)
        for k in range(3):
            fk = formants[t, k, 0]
            if fk <= 0:
                continue
            # amplitude of the F0 harmonic closest to the formant peak
            harm = max(1, int(round(fk / f0[t])))
            ak = _harmonic_mag(mag[t], freqs, harm * f0[t],
                               spacing=f0[t])
            if ak > 0 and h1 > 0:
                famp[t, k] = 20.0 * np.log10(ak / h1)
                if k == 2:
                    h1a3[t] = 20.0 * np.log10(h1 / ak)
    lld['logRelF0-H1-H2'] = h1h2
    lld['logRelF0-H1-A3'] = h1a3
    for k in range(3):
        lld[f'F{k + 1}frequency'] = formants[:n, k, 0]
        lld[f'F{k + 1}bandwidth'] = formants[:n, k, 1]
        lld[f'F{k + 1}amplitudeLogRelF0'] = famp[:, k]
    return lld


# ---------------------------------------------------------- functionals
# Track lists by smoothing variant (openSMILE cContourSmoother runs ONCE
# over each whole LLD track before any functional; 'nz' variants smooth
# within voiced runs).  smooth_tracks() materializes each needed variant
# a single time; the per-frame path then aggregates SLICES of the
# smoothed tracks — one smoothing pass for the file instead of one per
# output row, and window edges see the true neighboring frames instead
# of a clipped-run boundary.
_PLAIN_SMA3 = ('loudness', 'spectralFlux', 'mfcc1', 'mfcc2', 'mfcc3',
               'mfcc4')
_NZ_VOICED = ('F0semitone', 'jitterLocal', 'shimmerLocaldB', 'HNRdBACF',
              'logRelF0-H1-H2', 'logRelF0-H1-A3',
              'F1frequency', 'F1bandwidth', 'F1amplitudeLogRelF0',
              'F2frequency', 'F2bandwidth', 'F2amplitudeLogRelF0',
              'F3frequency', 'F3bandwidth', 'F3amplitudeLogRelF0',
              'alphaRatio', 'hammarbergIndex', 'slope0-500',
              'slope500-1500', 'spectralFlux', 'mfcc1', 'mfcc2', 'mfcc3',
              'mfcc4')
_NZ_UNVOICED = ('alphaRatio', 'hammarbergIndex', 'slope0-500',
                'slope500-1500', 'spectralFlux')


def smooth_tracks(lld: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One smoothing pass per needed (track, variant):
    ``<name>`` = plain sma3, ``<name>@v`` / ``<name>@uv`` = sma3nz over
    voiced / unvoiced runs.  Plus 'voiced' passed through."""
    voiced = lld['voiced'].astype(bool)
    sm: Dict[str, np.ndarray] = {'voiced': voiced}
    for name in _PLAIN_SMA3:
        sm[name] = _sma3(lld[name])
    for name in _NZ_VOICED:
        sm[name + '@v'] = _sma3nz(lld[name], voiced)
    for name in _NZ_UNVOICED:
        sm[name + '@uv'] = _sma3nz(lld[name], ~voiced)
    return sm


def _sma3(x: np.ndarray) -> np.ndarray:
    if len(x) < 3:
        return x.astype(np.float64)
    k = np.ones(3) / 3.0
    sm = np.convolve(x, k, mode='same')
    sm[0] = (x[0] + x[1]) / 2.0
    sm[-1] = (x[-1] + x[-2]) / 2.0
    return sm


def _sma3nz(x: np.ndarray, voiced: np.ndarray) -> np.ndarray:
    """Moving average WITHIN voiced runs; unvoiced frames stay 0."""
    out = np.zeros(len(x))
    for s, e in _runs(voiced):
        out[s:e] = _sma3(x[s:e])
    return out


def _runs(mask: np.ndarray):
    """(start, end) half-open index ranges of True runs."""
    if len(mask) == 0:
        return []
    d = np.diff(mask.astype(np.int8))
    starts = list(np.nonzero(d == 1)[0] + 1)
    ends = list(np.nonzero(d == -1)[0] + 1)
    if mask[0]:
        starts.insert(0, 0)
    if mask[-1]:
        ends.append(len(mask))
    return list(zip(starts, ends))


def _amean_stdnorm(x: np.ndarray) -> Tuple[float, float]:
    if len(x) == 0:
        return 0.0, 0.0
    m = float(x.mean())
    s = float(x.std())
    return m, (s / abs(m) if abs(m) > 1e-12 else 0.0)


def _segment_slopes(x: np.ndarray, rising: bool) -> np.ndarray:
    """Slopes (units/sec) of maximal monotone segments of the contour."""
    if len(x) < 2:
        return np.zeros(0)
    d = np.diff(x)
    mask = d > 0 if rising else d < 0
    slopes = []
    for s, e in _runs(mask):  # d-indices [s, e) -> x-indices [s, e]
        dt = (e - s) * LLD_HOP_SEC
        slopes.append((x[e] - x[s]) / dt)
    return np.asarray(slopes)


def _peaks_per_sec(x: np.ndarray) -> float:
    """Local maxima above the contour mean with prominence: between two
    counted peaks the contour must dip by >=10% of its range (drops the
    frame-rate ripple a bare local-max count would see)."""
    if len(x) < 3:
        return 0.0
    rng = float(x.max() - x.min())
    if rng <= 1e-12:
        return 0.0
    m = x.mean()
    cand = np.nonzero((x[1:-1] > x[:-2]) & (x[1:-1] >= x[2:])
                      & (x[1:-1] > m))[0] + 1
    count, prev = 0, None
    for i in cand:
        if prev is None:
            count, prev = count + 1, i
            continue
        valley = float(x[prev:i + 1].min())
        if valley <= min(x[prev], x[i]) - 0.1 * rng:
            count, prev = count + 1, i
        elif x[i] > x[prev]:
            prev = i  # same hump, keep its higher summit
    return count / (len(x) * LLD_HOP_SEC)


def _slope_stats(x: np.ndarray, sel: np.ndarray = None) -> list:
    """[meanRising, stdRising, meanFalling, stdFalling] of monotone
    segments; slopes are measured WITHIN each selected run so voiced-gap
    boundaries never fabricate a segment."""
    spans = [(0, len(x))] if sel is None else _runs(sel)
    rise = np.concatenate(
        [_segment_slopes(x[s:e], rising=True) for s, e in spans]
        or [np.zeros(0)])
    fall = np.concatenate(
        [_segment_slopes(x[s:e], rising=False) for s, e in spans]
        or [np.zeros(0)])
    rm = float(rise.mean()) if len(rise) else 0.0
    rs = float(rise.std()) if len(rise) else 0.0
    fm = float(fall.mean()) if len(fall) else 0.0
    fs = float(fall.std()) if len(fall) else 0.0
    return [rm, rs, fm, fs]


def _contour_funcs(x: np.ndarray, sel: np.ndarray = None) -> list:
    """The 10-functional block used for F0 and loudness: amean,
    stddevNorm, percentiles 20/50/80, range 20-80, mean/std rising and
    falling slopes.  ``sel``: frames the distribution stats run over
    (voiced for F0)."""
    vals = x if sel is None else x[sel]
    mean, stdn = _amean_stdnorm(vals)
    if len(vals):
        p20, p50, p80 = np.percentile(vals, [20, 50, 80])
    else:
        p20 = p50 = p80 = 0.0
    return [mean, stdn, float(p20), float(p50), float(p80),
            float(p80 - p20)] + _slope_stats(x, sel)


# The 14 sma3nz-voiced amean/stddevNorm tracks of columns 30-57, in
# opensmile's csv order (followed by the V spectral/mfcc blocks).
_VOICED_MEAN_TRACKS = (
    'jitterLocal', 'shimmerLocaldB', 'HNRdBACF',
    'logRelF0-H1-H2', 'logRelF0-H1-A3',
    'F1frequency', 'F1bandwidth', 'F1amplitudeLogRelF0',
    'F2frequency', 'F2bandwidth', 'F2amplitudeLogRelF0',
    'F3frequency', 'F3bandwidth', 'F3amplitudeLogRelF0')
_V_SPECTRAL = ('alphaRatio', 'hammarbergIndex', 'slope0-500',
               'slope500-1500', 'spectralFlux')


def _segment_stats(voiced: np.ndarray) -> list:
    """[VoicedSegmentsPerSec, mean/std voiced seg len, mean/std unvoiced
    seg len] of one window's voicing mask."""
    dur = max(len(voiced) * LLD_HOP_SEC, 1e-9)
    vruns = [(e - s) * LLD_HOP_SEC for s, e in _runs(voiced)
             if e - s >= 2]  # >=20 ms, drops single-frame flicker
    uruns = [(e - s) * LLD_HOP_SEC for s, e in _runs(~voiced)]
    return [len(vruns) / dur,
            float(np.mean(vruns)) if vruns else 0.0,
            float(np.std(vruns)) if vruns else 0.0,
            float(np.mean(uruns)) if uruns else 0.0,
            float(np.std(uruns)) if uruns else 0.0]


def _functionals_window(sm: Dict[str, np.ndarray], s: int, e: int,
                        level_db: float) -> np.ndarray:
    """(88,) functional vector over frames [s, e) of the SMOOTHED
    tracks — the single-window oracle the vectorized batch path
    (functionals_rows) is tested against."""
    voiced = sm['voiced'][s:e]
    out = []

    out += _contour_funcs(sm['F0semitone@v'][s:e], sel=voiced)
    loud = sm['loudness'][s:e]
    out += _contour_funcs(loud)

    out += list(_amean_stdnorm(sm['spectralFlux'][s:e]))
    for i in range(1, 5):
        out += list(_amean_stdnorm(sm[f'mfcc{i}'][s:e]))

    for name in _VOICED_MEAN_TRACKS:
        out += list(_amean_stdnorm(sm[name + '@v'][s:e][voiced]))
    for name in _V_SPECTRAL:
        out += list(_amean_stdnorm(sm[name + '@v'][s:e][voiced]))
    for i in range(1, 5):
        out += list(_amean_stdnorm(sm[f'mfcc{i}@v'][s:e][voiced]))
    for name in _NZ_UNVOICED:
        out.append(_amean_stdnorm(sm[name + '@uv'][s:e][~voiced])[0])

    out.append(_peaks_per_sec(loud))
    out += _segment_stats(voiced)
    out.append(level_db)

    vec = np.asarray(out, dtype=np.float32)
    assert vec.shape == (88,), vec.shape
    return np.nan_to_num(vec, posinf=0.0, neginf=0.0)


def functionals_from_lld(lld: Dict[str, np.ndarray],
                         wav_slice: np.ndarray = None) -> np.ndarray:
    """(88,) eGeMAPSv02 functional vector of the whole LLD range."""
    sm = smooth_tracks(lld)
    n = len(sm['voiced'])
    if wav_slice is not None and len(wav_slice):
        # same channel downmix as egemaps_per_frame (mean over channels
        # BEFORE squaring) so stereo input reports one level definition
        mono = np.asarray(wav_slice, np.float64)
        if mono.ndim > 1:
            mono = mono.mean(axis=1)
        level = 10.0 * np.log10(float(np.mean(mono ** 2)) + 1e-12)
    elif n:  # reconstruct from the loudness track when no waveform given
        level = 10.0 * np.log10(float(np.mean(
            lld['loudness'][:n] ** (1 / 0.3))) + 1e-12)
    else:
        level = -120.0
    return _functionals_window(sm, 0, n, level)


def functionals_rows(sm: Dict[str, np.ndarray], starts: np.ndarray,
                     ends: np.ndarray, level_db: np.ndarray) -> np.ndarray:
    """(R, 88) functional vectors over rows of [start, end) windows of
    the smoothed tracks — vectorized mean/std (masked cumulative sums)
    and percentiles (strided window views); only the run-based
    functionals (slopes, loudness peaks, segment stats: ~6 small numpy
    calls per row) remain per-row.  Equals the per-window oracle
    ``_functionals_window`` row for row (tests/test_egemaps.py)."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    R = len(starts)
    voiced = sm['voiced']
    vmask = voiced.astype(np.float64)
    uvmask = 1.0 - vmask

    def csum(x):
        out = np.empty(len(x) + 1, np.float64)
        out[0] = 0.0
        np.cumsum(x, dtype=np.float64, out=out[1:])
        return out

    cnt_all = (ends - starts).astype(np.float64)
    cs_v = csum(vmask)
    cnt_v = cs_v[ends] - cs_v[starts]
    cnt_uv = cnt_all - cnt_v

    def mean_stdnorm(x, which):
        """amean + stddevNorm per row over all/voiced/unvoiced frames,
        matching _amean_stdnorm (incl. its empty -> (0, 0) and
        |mean|<=1e-12 -> 0 conventions).  The sums run on the
        track-mean-CENTERED values: E[(x-off)^2] - E[x-off]^2 keeps full
        precision for high-mean/low-variance tracks (F1frequency ~500 Hz)
        where raw E[x^2] - mean^2 catastrophically cancels."""
        m = {'all': None, 'v': vmask, 'uv': uvmask}[which]
        cnt = {'all': cnt_all, 'v': cnt_v, 'uv': cnt_uv}[which]
        if m is None:
            off = float(x.mean()) if len(x) else 0.0
            xc = x - off
            xm = xc
        else:
            msum = float(m.sum())
            off = float((x * m).sum() / msum) if msum > 0 else 0.0
            xc = x - off
            xm = xc * m
        c1 = csum(xm)
        c2 = csum(xm * xc)  # == (x-off)^2 * m (m is 0/1)
        s1 = c1[ends] - c1[starts]
        s2 = c2[ends] - c2[starts]
        cn = np.maximum(cnt, 1.0)
        cmean = s1 / cn
        std = np.sqrt(np.maximum(s2 / cn - cmean * cmean, 0.0))
        mean = np.where(cnt > 0, off + cmean, 0.0)
        stdn = np.where((cnt > 0) & (np.abs(mean) > 1e-12),
                        std / np.maximum(np.abs(mean), 1e-300), 0.0)
        return mean, stdn

    def percentiles(x, which):
        """p20/p50/p80 per row (voiced-only when which == 'v'),
        grouped by window length so full-length rows ride one strided
        nanpercentile; empty selections -> 0 like the oracle."""
        out = np.zeros((R, 3))
        xa = np.where(vmask > 0, x, np.nan) if which == 'v' else x
        lens = ends - starts
        import warnings
        from numpy.lib.stride_tricks import sliding_window_view
        for L in np.unique(lens):
            rows = np.nonzero(lens == L)[0]
            if L <= 0:
                continue
            wv = sliding_window_view(xa, int(L))[starts[rows]]
            with warnings.catch_warnings():
                warnings.simplefilter('ignore', RuntimeWarning)
                p = np.nanpercentile(wv, [20, 50, 80], axis=1).T
            out[rows] = np.nan_to_num(p)
        if which == 'v':
            out[cnt_v == 0] = 0.0
        return out

    cols = np.zeros((R, 88))

    # F0 block (cols 0-9) and loudness block (cols 10-19)
    f0 = sm['F0semitone@v']
    loud = sm['loudness']
    for base, x, which in ((0, f0, 'v'), (10, loud, 'all')):
        mean, stdn = mean_stdnorm(x, which)
        p = percentiles(x, which)
        cols[:, base] = mean
        cols[:, base + 1] = stdn
        cols[:, base + 2:base + 5] = p
        cols[:, base + 5] = p[:, 2] - p[:, 0]
        sel = voiced if which == 'v' else None
        for r in range(R):
            s, e = starts[r], ends[r]
            cols[r, base + 6:base + 10] = _slope_stats(
                x[s:e], None if sel is None else sel[s:e])

    c = 20
    for name in ('spectralFlux', 'mfcc1', 'mfcc2', 'mfcc3', 'mfcc4'):
        cols[:, c], cols[:, c + 1] = mean_stdnorm(sm[name], 'all')
        c += 2
    for name in _VOICED_MEAN_TRACKS + _V_SPECTRAL:
        cols[:, c], cols[:, c + 1] = mean_stdnorm(sm[name + '@v'], 'v')
        c += 2
    for i in range(1, 5):
        cols[:, c], cols[:, c + 1] = mean_stdnorm(sm[f'mfcc{i}@v'], 'v')
        c += 2
    for name in _NZ_UNVOICED:
        cols[:, c] = mean_stdnorm(sm[name + '@uv'], 'uv')[0]
        c += 1
    assert c == 81, c

    for r in range(R):
        s, e = starts[r], ends[r]
        cols[r, 81] = _peaks_per_sec(loud[s:e])
        cols[r, 82:87] = _segment_stats(voiced[s:e])
    cols[:, 87] = np.asarray(level_db, np.float64)

    return np.nan_to_num(cols.astype(np.float32), posinf=0.0, neginf=0.0)


def egemaps_functionals(wav: np.ndarray, sr: int) -> np.ndarray:
    """Whole-file (88,) vector (opensmile ``process_file`` analogue)."""
    return functionals_from_lld(egemaps_lld(wav, sr), wav_slice=wav)


def egemaps_per_frame(wav: np.ndarray, sr: int, length: int,
                      target_frequency: float) -> np.ndarray:
    """(length, 88): row i aggregates the 1-second window starting at
    i/target_frequency — the reference's process_files scheme
    (base/audio.py:106-117).  LLDs are computed and smoothed ONCE (the
    openSMILE cContourSmoother placement: sma3/sma3nz run over the whole
    LLD track, so window edges see true neighboring frames); each row
    then aggregates its 100-frame slice through the vectorized
    functionals_rows (clamped at the tail, like openSMILE's shorter
    final windows)."""
    lld = egemaps_lld(wav, sr)
    sm = smooth_tracks(lld)
    n = len(sm['voiced'])
    win = int(round(1.0 / LLD_HOP_SEC))
    if length <= 0:
        return np.zeros((0, 88), np.float32)

    i = np.arange(length, dtype=np.float64)
    starts = np.rint(i / target_frequency / LLD_HOP_SEC).astype(np.int64)
    starts = np.clip(starts, 0, max(n - 1, 0))
    ends = np.minimum(starts + win, n)

    # equivalentSoundLevel_dBp from the raw waveform slice of each
    # window (cumulative sum of wav^2); empty slices fall back like the
    # whole-file path (loudness reconstruction is moot on 0 frames)
    mono = np.asarray(wav, np.float64)
    if mono.ndim > 1:
        mono = mono.mean(axis=1)
    cs2 = np.concatenate([[0.0], np.cumsum(mono ** 2)])
    sa = (starts * LLD_HOP_SEC * sr).astype(np.int64)
    se = (ends * LLD_HOP_SEC * sr).astype(np.int64)
    sa = np.clip(sa, 0, len(mono))
    se = np.clip(se, sa, len(mono))
    cnt = (se - sa).astype(np.float64)
    level = np.where(
        cnt > 0,
        10.0 * np.log10((cs2[se] - cs2[sa]) / np.maximum(cnt, 1.0)
                        + 1e-12),
        -120.0)

    return functionals_rows(sm, starts, ends, level)
