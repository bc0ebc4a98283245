"""Host-side batch loaders with threaded prefetch: a copy of
``fvt_tpu/data/loader.py`` on the port's modules (``epoch_local`` gives a
data-parallel rank its row slice of each batch, ``parallel/multihost.py``).

A thread-pool prefetch pipeline feeds numpy batches; the device upload
happens in the train or eval step.

Shape policy:
  * train: all windows are exactly ``window_length`` frames; the final
    partial batch keeps its true (smaller) batch size — loss semantics
    identical to the upstream trainer.
  * eval: videos padded to a bucket length (the next multiple of
    ``bucket_quantum``), same-bucket videos batched; frames beyond a
    video's length are padding the eval drops.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fvt_tpu_torch.data.dataset import ExampleBuilder
from fvt_tpu_torch.utils import rng as rng_mod


def _stack(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples], axis=0) for k in keys}


def _pump(jobs: Sequence, build, num_threads: int, prefetch: int
          ) -> Iterator:
    """Submit-ahead prefetch pipeline: keep up to ``prefetch`` builds in
    flight on a thread pool, yield results in job order.  The ONE
    implementation behind TrainLoader.epoch and EvalLoader.__iter__ /
    batches — a fix here reaches all three."""
    with cf.ThreadPoolExecutor(num_threads) as pool:
        pending = []
        it = iter(jobs)
        for _ in range(prefetch):
            job = next(it, None)
            if job is None:
                break
            pending.append(pool.submit(build, job))
        while pending:
            fut = pending.pop(0)
            job = next(it, None)
            if job is not None:
                pending.append(pool.submit(build, job))
            yield fut.result()


class TrainLoader:
    """Shuffled fixed-window batches; deterministic per-epoch order.

    With ``bucket_quantum`` set (--train_bucketed), short trials are
    padded by repeat only up to the next bucket multiple instead of the
    full model window — the per-frame loss weighting then differs from
    the reference's (which dilutes short clips with more repeated
    frames), but 3-4x of repeated-frame compute disappears on
    MELD-length clips.  Batches group same-bucket windows; batch ORDER
    is shuffled deterministically per epoch.
    """

    def __init__(self, work_list: list, builder: ExampleBuilder,
                 batch_size: int, seed: int, prefetch: int = 4,
                 num_threads: int = 8,
                 bucket_quantum: Optional[int] = None):
        self.work_list = list(work_list)
        self.builder = builder
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.bucket_quantum = bucket_quantum

    def __len__(self):
        # count from the actual plan: with bucket_quantum set, each
        # bucket yields its own remainder batch, so ceil(N/batch_size)
        # undercounts (the plan's length is epoch-independent — only
        # its ORDER is shuffled)
        return len(self._plan(0))

    def _bucket(self, item) -> int:
        window = self.builder.window_length
        length = item[2]
        if self.bucket_quantum is None or length >= window:
            return window
        return min(round_up(length, self.bucket_quantum), window)

    def _plan(self, epoch_idx: int) -> list:
        """Deterministic per-epoch batch plan: [(bucket, idx_array)].
        A pure function of (seed, epoch) — every host of a multi-process
        job derives the identical plan."""
        order = rng_mod.np_rng(
            rng_mod.epoch_seed(self.seed, epoch_idx),
            'train_order').permutation(len(self.work_list))

        if self.bucket_quantum is None:
            return [(None, order[i:i + self.batch_size])
                    for i in range(0, len(order), self.batch_size)]
        groups: Dict[int, list] = {}
        for i in order:  # shuffled order preserved inside buckets
            groups.setdefault(self._bucket(self.work_list[i]), []).append(i)
        batches = []
        for b in sorted(groups):
            idxs = groups[b]
            batches.extend(
                (b, np.asarray(idxs[s:s + self.batch_size]))
                for s in range(0, len(idxs), self.batch_size))
        perm = rng_mod.np_rng(
            rng_mod.epoch_seed(self.seed, epoch_idx),
            'train_bucket_order').permutation(len(batches))
        return [batches[j] for j in perm]

    def _build_batch(self, job) -> Dict[str, np.ndarray]:
        bucket, idxs = job
        return _stack([self.builder.build(self.work_list[i],
                                          pad_to=bucket)
                       for i in idxs])

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        return _pump(self._plan(epoch_idx), self._build_batch,
                     self.num_threads, self.prefetch)

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """Epoch 0's first batch, built synchronously — identical to
        ``next(iter(self.epoch(0)))`` but without spinning up the
        prefetch pump (which would build and then discard up to
        ``prefetch`` full batches; init_state only needs shapes)."""
        return self._build_batch(self._plan(0)[0])

    def epoch_local(self, epoch_idx: int, divisor: Optional[int] = None,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None):
        """Multi-host variant: yields (local_batch, global_rows) where
        local_batch is THIS process's contiguous row-slice of each
        global batch — only those examples are read/built here.  Batches
        whose size is not divisible by ``divisor`` (the global device
        count) or by the process count are built in FULL on every host
        (global_rows == local rows) for the replicated ragged path.
        process_count == 1 degenerates to epoch() + sizes."""
        from fvt_tpu_torch.parallel.multihost import host_slice

        def build(job):
            bucket, idxs = job
            rows = len(idxs)
            sl = None
            if divisor is None or rows % divisor == 0:
                sl = host_slice(rows, process_index, process_count)
            local = idxs if sl is None else idxs[sl[0]:sl[1]]
            batch = _stack([self.builder.build(self.work_list[i],
                                               pad_to=bucket)
                            for i in local])
            return batch, rows

        return _pump(self._plan(epoch_idx), build,
                     self.num_threads, self.prefetch)


def round_up(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


class EvalLoader:
    """One whole video per step: (batch, trial, true_length, bucket_length).

    ``true_length`` is the post-pad-by-repeat frame count (== reference's
    per-video frame count at eval); frames beyond it up to the bucket are
    padding, marked invalid in the mask.
    """

    def __init__(self, work_list: list, builder: ExampleBuilder,
                 bucket_quantum: int = 100, prefetch: int = 2,
                 num_threads: int = 4):
        self.work_list = list(work_list)
        self.builder = builder
        self.bucket_quantum = bucket_quantum
        self.prefetch = prefetch
        self.num_threads = num_threads

    def __len__(self):
        return len(self.work_list)

    def _build(self, item, center_crop: Optional[int] = None
               ) -> Tuple[Dict[str, np.ndarray], str, int, int]:
        path, trial, length, index = item
        example = self.builder.build(item, center_crop=center_crop)
        true_len = self.builder.padded_length(length)
        bucket = round_up(true_len, self.bucket_quantum)
        padded = {}
        for k, v in example.items():
            pad = bucket - v.shape[0]
            if pad:
                v = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
            padded[k] = v[None]  # add batch dim
        return padded, trial, true_len, bucket

    def __iter__(self):
        return _pump(self.work_list, self._build,
                     self.num_threads, self.prefetch)

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """First video's batch, built synchronously (no prefetch pump —
        see TrainLoader.sample_batch)."""
        return self._build(self.work_list[0])[0]

    def batches(self, batch_videos: int = 1,
                windowed_threshold: Optional[int] = None,
                center_crop: Optional[int] = None):
        """Group same-bucket videos into batches of up to ``batch_videos``.

        Yields (batch(B, bucket, ...), trials, true_lens, bucket).  Videos
        whose padded length exceeds ``windowed_threshold`` (the model
        window — they take the stitch path) are yielded as singletons.
        Outputs are per-video identical to the bs=1 path; only throughput
        changes.  ``center_crop`` ships video frames already center-
        cropped (eval's crop is deterministic; fused into the native
        gather+resize — see ExampleBuilder.build).
        """
        def bucket_of(item):
            tl = self.builder.padded_length(item[2])
            return round_up(tl, self.bucket_quantum)

        singles, groups = [], {}
        for item in self.work_list:
            b = bucket_of(item)
            if windowed_threshold is not None and \
                    self.builder.padded_length(item[2]) > windowed_threshold:
                singles.append(item)
            else:
                groups.setdefault(b, []).append(item)

        jobs = [[i] for i in singles]
        for b, items in sorted(groups.items()):
            for s in range(0, len(items), batch_videos):
                jobs.append(items[s:s + batch_videos])

        def build_job(job):
            built = [self._build(i, center_crop=center_crop) for i in job]
            batch = {k: np.concatenate([ex[0][k] for ex in built], axis=0)
                     for k in built[0][0]}
            trials = [ex[1] for ex in built]
            lens = [ex[2] for ex in built]
            return batch, trials, lens, built[0][3]

        return _pump(jobs, build_job, self.num_threads, self.prefetch)
