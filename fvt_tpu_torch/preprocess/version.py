"""Feature-extractor generation stamp: a copy of
``fvt_tpu/preprocess/version.py`` (the port reads the stamp; the
extractors stay in the JAX package), held equal to it by
``tests/test_torch_copies.py``.

Per-frame feature definitions are refined over time (e.g. the eGeMAPS
sma3/sma3nz smoothing moved from per-window to LLD-track level, changing
per-frame rows at window edges; the centered-variance stddevNorm fix).
A feature store built by one extractor generation is NOT bit-compatible
with one built by another, and nothing in the npy files themselves says
which generation produced them — so the stamp lives in each shard's
``dataset_info_*.pkl`` / ``processing_records_*.pkl``
(preprocess/driver.py), survives the shard merge (preprocess/merge.py
refuses to merge mixed generations), and is checked at load time
(experiment.load_dataset_info warns on mismatch).

Mirrors the spirit of the upstream project's per-trial processing_record
bookkeeping (its abaw5_pre_processing/base/preprocessing.py:344-351),
which records WHAT was extracted but not with WHICH code generation.

Bump ``EXTRACTOR_VERSION`` whenever a change alters the numeric content
of any extracted feature stream, and say what changed in ``CHANGELOG``.
"""
from __future__ import annotations

EXTRACTOR_VERSION = 2

CHANGELOG = {
    1: 'initial fvt_tpu extractor chain (rounds 1-3 early): per-window '
       'eGeMAPS smoothing',
    2: 'eGeMAPS sma3/sma3nz smoothing at LLD-track level (openSMILE '
       'cContourSmoother placement; per-frame rows changed at window '
       'edges) + centered-variance stddevNorm; stamped stores start '
       'here (round 4)',
}

STAMP_KEY = 'extractor_version'


def stamp(info: dict) -> dict:
    """Add the current generation stamp to a dataset_info/record dict."""
    info[STAMP_KEY] = EXTRACTOR_VERSION
    return info


def check(info: dict, source: str = '') -> str | None:
    """Return a human-readable warning when ``info`` was produced by a
    different (or unknown) extractor generation, else None."""
    v = info.get(STAMP_KEY)
    at = f' ({source})' if source else ''
    if v is None:
        return (f'dataset_info{at} carries no extractor_version stamp '
                f'(pre-r4 store): current extractor is generation '
                f'{EXTRACTOR_VERSION}; per-frame features (notably '
                f'eGeMAPS) may differ from what this code would extract')
    if v != EXTRACTOR_VERSION:
        return (f'dataset_info{at} was built by extractor generation '
                f'{v}, but this code is generation {EXTRACTOR_VERSION} '
                f'— mixing stores across generations changes per-frame '
                f'features: {CHANGELOG.get(EXTRACTOR_VERSION, "")}')
    return None
