"""Online (streaming) sliding-window inference over serving models.
A copy of ``fvt_tpu/streaming.py`` (numpy and threading only), whose
behaviour ``tests/test_torch_copies.py`` holds equal to the original's;
it serves :class:`fvt_tpu_torch.serve.ServingModel`.

The upstream stack is strictly offline: it windows a COMPLETE video
(its trainer.py:894-912), forwards every window, and stitches with a
Counter average (trainer.py:832-892).
`StreamingSession` produces the SAME per-frame logits while frames
arrive incrementally — the production shape for live emotion
recognition, which the reference cannot express at all.

Contract (pinned by tests/test_streaming.py): for any chunking of the
input — one frame at a time included — the concatenated streamed
output is BIT-IDENTICAL to the offline path through the same artifact
(`tools/infer_artifact.py` semantics, itself pinned against
`Trainer.inference`):

  * long videos (L >= window): `stitch_windows_np` over the reference
    windowing rule (starts 0, hop, 2*hop, ... plus the tail window
    [L-window, L) — data/windowing.py:22-30);
  * short videos (L < window): the padded bucket path — one
    pad-by-repeat window (data/windowing.py:111-121), first L rows.

Finalization math.  The tail window's start (L - window) is unknown
until the stream closes, but any not-yet-run window — regular or tail —
must start at ``>= received - window`` (a regular start s is only
deferred while s + window > received; the tail starts at
L - window >= received - window).  Hence every frame
``t < received - window`` can never gain another covering window: its
average is FINAL and is emitted immediately.  The same bound lets the
session trim its frame buffer to the last ``window`` frames plus any
not-yet-windowed suffix, so memory is O(window + feed chunk), not O(L).

Bitwise equality holds because (a) eval-mode window forwards are
row-independent (no cross-batch reduction: BatchNorm runs on running
stats), so a window's logits do not depend on which rows share its
batch, and (b) windows are committed into the float32 scatter-sum in
ascending start order — the exact addition order of the offline
``np.add.at`` — and the count division happens once, at finalization.

Dynamic (cross-session) batching.  Row-independence also means windows
from DIFFERENT sessions can share one device batch without changing any
output bit.  `WindowBatcher` exploits that: sessions submit ready
windows into one shared queue and a dispatch fires whenever
``window_batch`` rows accumulate — from any mix of streams — instead of
each low-rate stream waiting to fill (or repeat-padding) its own batch.
Sharing is GATED to row-independent models: JMT/MT's final attention
flattens (B*T) into one sequence (models/fusion.py:190-200, the
faithfully-ported reference quirk), so their batch rows attend to each
other and outputs depend on batch composition — those models keep
per-session batches, whose composition matches the offline path row
for row (so equality still holds; it just can't pack across streams).
Per-session commit order stays ascending (the shared queue is FIFO and
each session submits in ascending start order), so the stitched output
of every session is still bit-identical to its offline path; only the
*when* of finalization changes.  This is the serving shape that keeps
the device fed under many concurrent 1-frame-at-a-time streams — the
reference stack has no serving story at all, let alone a batched one.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from fvt_tpu_torch.data import windowing as W
from fvt_tpu_torch.utils import bf16


class CapacityError(RuntimeError):
    """Raised by :meth:`StreamingRegistry.open` when ``max_sessions``
    live sessions already exist — the admission guard against open
    floods (mapped to HTTP 503 by ``tools/serve_http.py``)."""


def _conform(arr: np.ndarray, dtype_name: str) -> np.ndarray:
    if dtype_name == 'bfloat16':
        # fvt_tpu casts through ml_dtypes, which the card's machine does
        # not have: the port carries bfloat16 as its raw bits, rounded as
        # ml_dtypes rounds
        return bf16.as_bits(arr)
    want = np.dtype(dtype_name)
    return arr if arr.dtype == want else arr.astype(want)


class WindowBatcher:
    """Packs ready windows — from one or MANY sessions — into full
    ``window_batch`` device dispatches.

    Each submitted row is ``(window_inputs, callback, true_length)``;
    a dispatch fires as soon as ``window_batch`` rows are queued, and
    ``flush()`` runs the remainder with repeat-padding of the last row
    (exactly the per-session padding rule, so a lone short-video window
    flushed here produces the same broadcast batch the bucket path
    builds).  Masked models ride a per-row length vector (uniform in
    practice: they are barred from sharing — see ``shared`` — and one
    session never mixes full and short rows).

    NOT self-locking: callers serialize access (StreamingRegistry holds
    one lock across feed/poll/close and the stale-flush thread; a
    session's private batcher is only touched by that session).
    ``dispatches`` / ``rows_padded`` count real device batches and
    wasted pad rows — the packing win is their ratio vs per-session
    batching."""

    def __init__(self, art, *, window: Optional[int] = None, mesh=None,
                 shared: bool = False):
        self.art = art
        self.mesh = mesh
        self.shared = bool(shared)
        meta = art.meta
        if self.shared:
            # JMT/MT flatten (B*T) into the final attention's sequence
            # axis — rows mix, so outputs would depend on which streams
            # share the batch; exactly the needs_mask models
            assert not meta.get('needs_mask'), (
                f"model {meta.get('model_name')!r} mixes batch rows "
                f"(flattened (B*T) final attention); cross-session "
                f"batching would change its outputs — only "
                f"row-independent models (LFAN/CAN) can share a "
                f"WindowBatcher")
        self.window = int(window or meta['window_length'])
        key = next((k for k, v in meta['shapes'].items()
                    if v['seq_len'] == self.window), None)
        assert key is not None, (
            f"artifact has no export at seq_len == window "
            f"({self.window}); available: {list(meta['shapes'])}")
        self.shape_key = key
        self.wb = int(meta['shapes'][key]['window_batch'])
        self.needs_mask = bool(meta.get('needs_mask'))
        # (callback, {mod: (W, ...)}, row_length, enqueue_monotonic)
        self._queue: List[Tuple[Callable[[np.ndarray], None],
                                Dict[str, np.ndarray], int, float]] = []
        self.dispatches = 0
        self.rows_padded = 0

    def submit(self, win: Dict[str, np.ndarray],
               callback: Callable[[np.ndarray], None],
               length: Optional[int] = None) -> None:
        self._queue.append((callback, win, int(length or self.window),
                            time.monotonic()))
        while len(self._queue) >= self.wb:
            take = self._queue[:self.wb]
            del self._queue[:self.wb]
            self._dispatch(take)

    def flush(self) -> None:
        """Dispatch everything queued (last batch repeat-padded)."""
        while self._queue:
            take = self._queue[:self.wb]
            del self._queue[:self.wb]
            self._dispatch(take)

    def flush_stale(self, max_delay_s: float) -> bool:
        """Flush iff the OLDEST queued row has waited > max_delay_s —
        the latency bound for sparse traffic that never fills a batch."""
        if self._queue and (time.monotonic() - self._queue[0][3]
                            > max_delay_s):
            self.flush()
            return True
        return False

    def _dispatch(self, take) -> None:
        rows = take + [take[-1]] * (self.wb - len(take))
        inputs = {k: np.stack([r[1][k] for r in rows])
                  for k in rows[0][1]}
        length = (np.array([r[2] for r in rows], np.int32)
                  if self.needs_mask else None)
        if self.mesh is not None:
            out = self.art.call_sharded(inputs, mesh=self.mesh,
                                        length=length)
        else:
            out = self.art.call(inputs, length=length)
        out = np.asarray(out)
        self.dispatches += 1
        self.rows_padded += self.wb - len(take)
        for i, (cb, *_rest) in enumerate(take):
            cb(out[i])


class StreamingSession:
    """Incremental sliding-window inference bound to one ServingArtifact.

    >>> sess = StreamingSession(art)
    >>> start, logits = sess.feed({'vggish': chunk_v, 'bert': chunk_b})
    >>> ...                       # (start, (n, C)) finalized frames
    >>> start, logits = sess.close()   # flushes the tail

    ``feed`` accepts per-modality arrays of IDENTICAL leading length
    (the chunk's frame count; any length >= 0) and returns the frames
    whose stitched logits became final.  Dispatches ride the artifact's
    exported ``(window_batch, window)`` shape; ready windows are queued
    and sent once ``window_batch`` accumulate (``close`` flushes a
    partial batch with repeat-padding, like tools/infer_artifact.py).
    Pass ``mesh=`` to dispatch each batch data-parallel via
    ``ServingArtifact.call_sharded``, or ``batcher=`` (a shared
    `WindowBatcher`) to pack this session's windows into device batches
    WITH other sessions' — same bits, fuller batches; ``poll()`` then
    surfaces frames another session's dispatch finalized.
    """

    def __init__(self, art, *, window: Optional[int] = None,
                 hop: Optional[int] = None, mesh=None, batcher=None):
        self.art = art
        meta = art.meta
        self.window = int(window or meta['window_length'])
        self.hop = int(hop or meta['hop_length'])
        assert self.window > 0 and self.hop > 0, (self.window, self.hop)
        if batcher is None:
            batcher = WindowBatcher(art, window=self.window, mesh=mesh)
        else:
            assert batcher.shared, (
                'construct cross-session batchers with '
                'WindowBatcher(art, shared=True) — the flag runs the '
                'row-independence gate')
            assert batcher.art is art, \
                'shared batcher is bound to a different artifact'
            assert batcher.window == self.window, (
                f"shared batcher serves window {batcher.window}, "
                f"session wants {self.window}")
            assert mesh is None or mesh is batcher.mesh, \
                'pass the mesh to the shared batcher, not the session'
        self.batcher = batcher
        self.shape_key = batcher.shape_key
        self.spec = meta['shapes'][self.shape_key]['inputs']
        self.wb = batcher.wb
        self.num_classes = int(meta['num_classes'])
        self.needs_mask = batcher.needs_mask

        self.received = 0          # total frames fed so far
        self.next_start = 0        # next regular window start to extract
        self.emitted = 0           # frames already finalized + returned
        self.closed = False
        self.finishing = False     # end-of-stream declared (finish())
        self._short_out: Optional[np.ndarray] = None
        # frame buffers: one contiguous array per modality holding
        # frames [base, received)
        self._base = 0
        self._buf: Dict[str, np.ndarray] = {}
        # starts submitted to the batcher, not yet committed (ascending;
        # commits are FIFO so this is popped from the front)
        self._inflight: List[int] = []
        # stitch accumulators for frames [emitted, ...)
        self._summed = np.zeros((0, self.num_classes), np.float32)
        self._counts = np.zeros((0,), np.float32)

    # -- internals ----------------------------------------------------

    def _grow_accum(self, upto: int) -> None:
        need = upto - self.emitted
        if need > len(self._counts):
            pad = need - len(self._counts)
            self._summed = np.concatenate(
                [self._summed, np.zeros((pad, self.num_classes),
                                        np.float32)])
            self._counts = np.concatenate(
                [self._counts, np.zeros((pad,), np.float32)])

    def _commit(self, start: int, out: np.ndarray) -> None:
        """Scatter one window's logits (float32, ascending-start order —
        the offline np.add.at addition order)."""
        assert self._inflight and self._inflight[0] == start, (
            start, self._inflight[:1])
        self._inflight.pop(0)
        self._grow_accum(start + self.window)
        o = start - self.emitted
        self._summed[o:o + self.window] += out.astype(np.float32)
        self._counts[o:o + self.window] += 1.0

    def _submit(self, start: int, win: Dict[str, np.ndarray]) -> None:
        self._inflight.append(start)
        self.batcher.submit(
            win, lambda out, s=start: self._commit(s, out))

    def _extract_ready(self) -> None:
        while self.next_start + self.window <= self.received:
            s = self.next_start
            o = s - self._base
            win = {k: np.ascontiguousarray(v[o:o + self.window])
                   for k, v in self._buf.items()}
            self._submit(s, win)
            self.next_start += self.hop
        # frames below BOTH the next regular start and the earliest
        # possible tail start (received - window) are never read again
        keep_from = min(self.next_start,
                        max(0, self.received - self.window))
        if keep_from > self._base:
            cut = keep_from - self._base
            self._buf = {k: v[cut:] for k, v in self._buf.items()}
            self._base = keep_from

    def _emit(self, upto: int) -> Tuple[int, np.ndarray]:
        """Finalize frames [emitted, upto): divide by counts, pop."""
        n = upto - self.emitted
        if n <= 0:
            return self.emitted, np.zeros((0, self.num_classes),
                                          np.float32)
        self._grow_accum(upto)
        # zero-coverage frames (hop > window configs) stay 0 like the
        # reference's Counter division — same guard as stitch_windows_np
        logits = (self._summed[:n]
                  / np.maximum(self._counts[:n], 1.0)[:, None])
        start = self.emitted
        self._summed = self._summed[n:]
        self._counts = self._counts[n:]
        self.emitted = upto
        return start, logits

    # -- public API ---------------------------------------------------

    @property
    def buffered_frames(self) -> int:
        """Frames currently held (memory bound: O(window + chunk))."""
        return self.received - self._base

    def feed(self, frames: Dict[str, np.ndarray]
             ) -> Tuple[int, np.ndarray]:
        """Append a chunk; returns (start_index, (n, C) logits) of the
        frames finalized by this chunk (n may be 0)."""
        assert not self.closed, 'session is closed'
        assert not self.finishing, 'session is finishing (no more feeds)'
        assert frames, 'empty modality dict'
        lens = {k: len(v) for k, v in frames.items()}
        assert len(set(lens.values())) == 1, (
            f"modalities disagree on chunk length: {lens}")
        want = set(self.spec)
        assert set(frames) == want, (
            f"expected modalities {sorted(want)}, got {sorted(frames)}")
        n = next(iter(lens.values()))
        for k, v in frames.items():
            tail = tuple(self.spec[k]['shape'][2:])
            assert tuple(v.shape[1:]) == tail, (
                f"{k}: per-frame shape {v.shape[1:]} != spec {tail}")
        if n:
            for k, v in frames.items():
                v = _conform(np.asarray(v), self.spec[k]['dtype'])
                self._buf[k] = (np.concatenate([self._buf[k], v])
                                if k in self._buf and len(self._buf[k])
                                else np.ascontiguousarray(v))
            self.received += n
        self._extract_ready()
        return self.poll()

    def poll(self) -> Tuple[int, np.ndarray]:
        """Frames finalized since the last feed/poll, WITHOUT feeding —
        under a shared `WindowBatcher`, another session's dispatch (or
        the registry's stale flush) may have committed this session's
        in-flight windows between requests; poll surfaces them.  After
        ``finish()``, polling drains the stream to its last frame once
        the remaining windows have been dispatched (``done`` flips)."""
        assert not self.closed, 'session is closed'
        if self.finishing and not self._inflight:
            L = self.received
            if 0 < L < self.window:
                # short-video bucket result arrives via _short_out
                if self._short_out is None or self.emitted == L:
                    return self.emitted, np.zeros(
                        (0, self.num_classes), np.float32)
                out = self._short_out[:L].astype(np.float32)
                self.emitted = L
                return 0, out
            return self._emit(L)
        # safe bound: no future window can start below received-window,
        # and nothing at/above the earliest still-IN-FLIGHT start
        # (submitted but waiting in the batcher queue) is committed yet
        pending = self._inflight[0] if self._inflight else self.received
        return self._emit(max(self.emitted,
                              min(self.received - self.window, pending)))

    @property
    def done(self) -> bool:
        """True once the stream is finished AND every frame delivered."""
        return (self.finishing and not self._inflight
                and self.emitted == self.received)

    def finish(self) -> Tuple[int, np.ndarray]:
        """Declare end-of-stream: submit the tail window(s) WITHOUT
        forcing a flush, so under a shared batcher the tails of many
        finishing streams pack into full dispatches instead of each
        padding its own; finish+drain keeps the packing).  Returns
        frames finalized so far; the remainder
        arrives via ``poll()`` once other traffic or the registry's
        stale flush dispatches the queue (``done`` flips when drained).
        ``close()`` remains the synchronous one-call variant."""
        assert not self.closed, 'session is closed'
        assert not self.finishing, 'finish() already called'
        self.finishing = True
        L = self.received
        if L == 0:
            return self.emitted, np.zeros((0, self.num_classes),
                                          np.float32)
        if L < self.window:
            # offline short-video semantics: ONE pad-by-repeat window,
            # first L rows (data/windowing.py:111-121; bucket path in
            # train/trainer.py:648-664) — NOT a stitch (the repeated
            # tail rows are discarded, not averaged into frame L-1).
            # Submitted as ONE batcher row with true length L: alone it
            # flushes as the same repeat-padded broadcast batch the
            # bucket path builds; under a shared batcher it rides other
            # sessions' full windows (per-row mask lengths keep masked
            # models exact — unreachable while sharing is gated to
            # unmasked models, but kept correct), bit-identical either
            # way.
            idx = W.pad_short_window_indices(L, self.window)
            win = {k: np.ascontiguousarray(v[idx])
                   for k, v in self._buf.items()}
            self.batcher.submit(
                win, lambda out: setattr(self, '_short_out', out),
                length=L)
        else:
            # remaining windows are exactly the unsubmitted suffix of
            # the full start list: the submitted regular starts 0, hop,
            # ... are its prefix, and only the tail [L-window, L) can
            # be new
            starts = W.window_starts(L, self.window, self.hop)
            n_submitted = sum(1 for s in starts
                              if s < self.next_start
                              and s % self.hop == 0)
            for s in starts[n_submitted:]:
                o = s - self._base
                assert o >= 0, (s, self._base)
                win = {k: np.ascontiguousarray(v[o:o + self.window])
                       for k, v in self._buf.items()}
                self._submit(s, win)
        self._buf = {}
        if not self.batcher.shared:
            # no cross-stream traffic will ever pack these tail rows,
            # and nothing else flushes a PRIVATE batcher (the registry
            # stale-flusher only covers the shared one) — without this,
            # `done` never flips on a non-dynamic_batch server and
            # clients poll forever
            self.batcher.flush()
        return self.poll()

    def close(self) -> Tuple[int, np.ndarray]:
        """Synchronous finish: run the tail window(s) NOW (flushing the
        batcher) and return every remaining frame."""
        assert not self.closed, 'session is closed'
        start = self.emitted
        pieces = []
        if not self.finishing:
            _, first = self.finish()
            pieces.append(first)
        self.batcher.flush()
        _, rest = self.poll()
        pieces.append(rest)
        self.closed = True
        out = [p for p in pieces if len(p)]
        return start, (np.concatenate(out) if out
                       else np.zeros((0, self.num_classes), np.float32))


class StreamingRegistry:
    """Thread-safe session book-keeping for the HTTP server.

    ``dynamic_batch=True`` gives every session ONE shared
    `WindowBatcher`: device batches fill with windows from whichever
    streams have them ready (outputs unchanged — see module docstring).
    ``max_delay_s`` bounds batching latency: a daemon thread flushes
    any queue — the shared one, or every session's private batcher
    when not dynamic-batching — whose oldest window has waited longer,
    so sparse traffic that never fills a batch still finalizes promptly
    (clients observe it via ``poll``/the next ``feed``).
    ``session_ttl_s > 0`` expires sessions that made NO request for a
    full TTL, so open-and-vanish clients can't accumulate server state
    (``expired_sessions`` counts them; any of their windows still
    queued dispatch and commit harmlessly).  ``max_sessions > 0`` is
    the admission guard the TTL can't be: a burst of ``open``s beyond
    it raises :class:`CapacityError` (HTTP 503) instead of growing
    accumulator state without bound (``rejected_sessions`` counts
    refusals).  One lock serializes
    feeds/polls/closes AND the housekeeping daemon — batcher callbacks
    touch other sessions' accumulators, so everything that can dispatch
    must hold it."""

    def __init__(self, art, mesh=None, dynamic_batch: bool = False,
                 max_delay_s: float = 0.0, session_ttl_s: float = 0.0,
                 max_sessions: int = 0):
        self.art = art
        self.mesh = mesh
        self._lock = threading.Lock()
        self._sessions: Dict[str, StreamingSession] = {}
        self._last_seen: Dict[str, float] = {}
        self.batcher = (WindowBatcher(art, mesh=mesh, shared=True)
                        if dynamic_batch else None)
        self.max_delay_s = float(max_delay_s)
        # a shared batcher with NO latency bound is a foot-gun outside
        # tests: a lone stream's finish()ed tail is dispatched only by
        # other traffic, the stale flusher, or close()/drain() — a
        # polling client would wait forever (and its polls refresh the
        # TTL).  serve_http refuses --dynamic_batch --batch_delay_ms 0
        # for this reason; library users driving dispatch manually
        # (tests, batch pipelines) may pass max_delay_s=0 deliberately.
        self.session_ttl_s = float(session_ttl_s)
        self.max_sessions = int(max_sessions)
        self.expired_sessions = 0
        self.rejected_sessions = 0
        self.draining = False
        self._stop = threading.Event()
        self._housekeeper: Optional[threading.Thread] = None
        if self.max_delay_s > 0 or self.session_ttl_s > 0:
            self._housekeeper = threading.Thread(
                target=self._housekeeping_loop, daemon=True,
                name='fvt-stream-housekeeping')
            self._housekeeper.start()

    def _housekeeping_loop(self) -> None:
        periods = [p for p in (self.max_delay_s / 4,
                               self.session_ttl_s / 4) if p > 0]
        tick = max(min([0.25] + periods), 0.001)
        while not self._stop.wait(tick):
            with self._lock:
                if self.max_delay_s > 0:
                    if self.batcher is not None:
                        self.batcher.flush_stale(self.max_delay_s)
                    else:
                        # private batchers: no other stream's traffic
                        # will ever dispatch a parked partial queue, so
                        # the latency bound must flush each one — EXCEPT
                        # masked models (JMT/MT): their rows attend
                        # across the batch, so a timing-dependent early
                        # flush would change dispatch composition and
                        # break the bit-identity to the offline stitch
                        # (the same reason they can't share batches);
                        # they keep the offline grouping and finalize on
                        # full batches / finish / close only
                        for sess in self._sessions.values():
                            if not sess.batcher.needs_mask:
                                sess.batcher.flush_stale(self.max_delay_s)
                if self.session_ttl_s > 0:
                    # drop ABANDONED sessions (no request for a full
                    # TTL) so open-and-vanish clients can't accumulate
                    # state; any of their windows still queued in the
                    # shared batcher dispatch + commit harmlessly
                    cut = time.monotonic() - self.session_ttl_s
                    for sid in [s for s, t in self._last_seen.items()
                                if t < cut]:
                        del self._sessions[sid]
                        del self._last_seen[sid]
                        self.expired_sessions += 1

    def stop(self) -> None:
        """Stop the housekeeping thread (server shutdown)."""
        self._stop.set()
        if self._housekeeper is not None:
            self._housekeeper.join(timeout=5)

    def _drop(self, sid: str) -> None:
        del self._sessions[sid]
        self._last_seen.pop(sid, None)

    def drain(self) -> int:
        """Enter graceful-shutdown mode: new ``open``s are refused
        (:class:`CapacityError` → 503) while existing streams keep
        feeding/finishing/polling to completion; the shared batcher is
        flushed so every already-queued window commits and becomes
        pollable.  Returns the number of still-live sessions — the
        caller (``serve_http`` on SIGTERM/SIGINT) waits for it to reach
        zero or a deadline before tearing the server down."""
        with self._lock:
            self.draining = True
            if self.batcher is not None:
                self.batcher.flush()
            return len(self._sessions)

    @property
    def live_sessions(self) -> int:
        return len(self._sessions)

    def open(self) -> str:
        sid = uuid.uuid4().hex[:12]
        with self._lock:
            if self.draining:
                self.rejected_sessions += 1
                raise CapacityError(
                    'server is draining for shutdown; no new sessions')
            if (self.max_sessions
                    and len(self._sessions) >= self.max_sessions):
                self.rejected_sessions += 1
                raise CapacityError(
                    f'{len(self._sessions)} live sessions '
                    f'(max_sessions={self.max_sessions}); retry later '
                    f'or close/finish existing streams')
            self._sessions[sid] = StreamingSession(
                self.art, mesh=None if self.batcher else self.mesh,
                batcher=self.batcher)
            self._last_seen[sid] = time.monotonic()
        return sid

    def feed(self, sid: str, frames) -> Tuple[int, np.ndarray]:
        with self._lock:
            sess = self._sessions[sid]
            self._last_seen[sid] = time.monotonic()
            return sess.feed(frames)

    def poll(self, sid: str) -> Tuple[int, np.ndarray, bool]:
        """(start, logits, done) — done means the finished stream is
        fully drained; the session is dropped once that is observed."""
        with self._lock:
            sess = self._sessions[sid]
            self._last_seen[sid] = time.monotonic()
            start, logits = sess.poll()
            if sess.done:
                self._drop(sid)
            return start, logits, sess.done

    def finish(self, sid: str) -> Tuple[int, np.ndarray, bool]:
        """Two-phase close: submit the stream's tail into the shared
        queue WITHOUT flushing (tails pack with other streams' traffic;
        the stale flusher bounds the wait) — keep ``poll``ing until
        done.  Under dynamic batching this is the efficient way to end
        a stream; ``close`` pays a padded flush for immediacy."""
        with self._lock:
            sess = self._sessions[sid]
            self._last_seen[sid] = time.monotonic()
            start, logits = sess.finish()
            if sess.done:
                self._drop(sid)
            return start, logits, sess.done

    def close(self, sid: str) -> Tuple[int, np.ndarray]:
        with self._lock:
            sess = self._sessions.pop(sid)
            self._last_seen.pop(sid, None)
            return sess.close()
