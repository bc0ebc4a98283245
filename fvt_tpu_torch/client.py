"""Stdlib-only Python client for the fvt_tpu_torch serving endpoint.

Wraps the wire protocol of ``tools/serve_http.py`` (npz bodies over
HTTP — see its module docstring for the endpoint reference) so a
consumer needs numpy and this file, nothing else: no jax, no model
code, no artifact on the client host.  The reference stack has no
serving story at all (every consumer re-hosts the full training stack,
the upstream inference_challenge.py); this is the thin edge of the
deployment contract DESIGN.md §12-13 describe.

    from fvt_tpu_torch.client import ServingClient
    c = ServingClient('http://host:8700')
    c.healthz()                      # server + batching stats
    logits = c.logits(batch)         # offline: (B, T, C) in one shot

    s = c.open_stream()              # online: frames in, logits out
    for chunk in chunks:             # any chunk length, 1 frame up
        for start, lg in s.feed(chunk):
            ...                      # frames finalized so far
    for start, lg in s.finish():     # two-phase close: tail packs
        ...                          # with other streams' traffic
    # or: s.result() after finish() — blocks until 'done', returns
    # the full (L, C) array reassembled in order.

``ServingClient.stream(arrays, chunk)`` is the convenience loop: feeds
a whole clip chunk-wise and returns the stitched (L, C) logits —
bit-identical to POST /logits on the same frames (pinned in
tests/test_streaming.py).

Server-hygiene responses surface as typed errors: HTTP 503 (draining /
max_sessions admission refusal) raises ``ServerBusy`` — retry later;
404 after a session expired or closed raises ``SessionGone``.
"""
from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class ServingError(RuntimeError):
    """Base class: any non-2xx response from the serving endpoint."""

    def __init__(self, code: int, message: str):
        super().__init__(f'HTTP {code}: {message}')
        self.code = code


class ServerBusy(ServingError):
    """503 — server draining for shutdown or at max_sessions."""


class SessionGone(ServingError):
    """404 — the stream id is unknown (closed, drained, or expired
    by the server's idle TTL)."""


def _raise_for(code: int, body: bytes):
    try:
        msg = json.loads(body).get('error', body.decode('utf-8', 'replace'))
    except Exception:
        msg = body.decode('utf-8', 'replace')
    if code == 503:
        raise ServerBusy(code, msg)
    if code == 404:
        raise SessionGone(code, msg)
    raise ServingError(code, msg)


class ServingClient:
    """One serving endpoint (``base_url``), any number of requests.

    ``timeout`` is per-HTTP-call (seconds).  Stateless apart from the
    URL — safe to share across threads (each call opens its own
    connection; the server is a ThreadingHTTPServer)."""

    def __init__(self, base_url: str, timeout: float = 60.0):
        self.base_url = base_url.rstrip('/')
        self.timeout = float(timeout)

    # -- plumbing ------------------------------------------------------
    def _request(self, path: str, body: Optional[bytes] = None,
                 method: str = 'GET') -> Tuple[int, bytes]:
        req = urllib.request.Request(
            self.base_url + path, data=body, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _post_npz(self, path: str,
                  arrays: Optional[Dict[str, np.ndarray]] = None
                  ) -> Dict[str, np.ndarray]:
        body = b''
        if arrays:
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            body = buf.getvalue()
        code, payload = self._request(path, body, method='POST')
        if code != 200:
            _raise_for(code, payload)
        with np.load(io.BytesIO(payload)) as z:
            return {k: z[k] for k in z.files}

    def _get_json(self, path: str) -> dict:
        code, payload = self._request(path)
        if code != 200:
            _raise_for(code, payload)
        return json.loads(payload)

    # -- offline -------------------------------------------------------
    def healthz(self) -> dict:
        return self._get_json('/healthz')

    def meta(self) -> dict:
        return self._get_json('/meta')

    def logits(self, arrays: Dict[str, np.ndarray],
               length: Optional[np.ndarray] = None) -> np.ndarray:
        """POST /logits: one already-windowed (B, T, ...) batch per
        modality [+ optional (B,) true lengths for masked models];
        returns (B, T, C) float32."""
        batch = dict(arrays)
        if length is not None:
            batch['length'] = np.asarray(length, np.int32)
        return self._post_npz('/logits', batch)['logits']

    # -- streaming -----------------------------------------------------
    def open_stream(self) -> 'StreamHandle':
        code, payload = self._request('/stream/open', b'', method='POST')
        if code != 200:
            _raise_for(code, payload)
        return StreamHandle(self, json.loads(payload)['sid'])

    def stream(self, arrays: Dict[str, np.ndarray], chunk: int = 1,
               poll_s: float = 0.02, timeout_s: float = 300.0
               ) -> np.ndarray:
        """Feed a whole (L, ...) clip ``chunk`` frames at a time through
        a fresh stream and return the stitched (L, C) logits —
        bit-identical to ``logits`` on the offline windowing of the
        same frames."""
        L = len(next(iter(arrays.values())))
        s = self.open_stream()
        try:
            for off in range(0, L, chunk):
                s.feed({k: v[off:off + chunk]
                        for k, v in arrays.items()})
            s.finish()
            return s.result(poll_s=poll_s, timeout_s=timeout_s)
        except BaseException:
            # don't leak the server-side session (it would count
            # against --max_sessions until the idle TTL reaps it)
            if not s.done:
                try:
                    s.close()
                except Exception:
                    pass
            raise


class StreamHandle:
    """One live stream.  ``feed``/``poll``/``finish`` return the list of
    ``(start, logits)`` pieces the server finalized since the previous
    call (possibly empty — under ``--dynamic_batch`` another stream's
    dispatch may finalize this one's frames between calls); the handle
    reassembles everything it has seen, so ``result()`` after
    ``finish()`` blocks until the server reports the stream drained and
    returns the full (L, C) array."""

    def __init__(self, client: ServingClient, sid: str):
        self.client = client
        self.sid = sid
        self.done = False
        self._pieces: List[Tuple[int, np.ndarray]] = []

    def _call(self, verb: str,
              arrays: Optional[Dict[str, np.ndarray]] = None
              ) -> List[Tuple[int, np.ndarray]]:
        out = self.client._post_npz(f'/stream/{self.sid}/{verb}', arrays)
        if 'done' in out:
            self.done = bool(out['done'])
        piece = (int(out['start']), out['logits'])
        if len(piece[1]):
            self._pieces.append(piece)
            return [piece]
        return []

    def feed(self, arrays: Dict[str, np.ndarray]
             ) -> List[Tuple[int, np.ndarray]]:
        return self._call('feed', arrays)

    def poll(self) -> List[Tuple[int, np.ndarray]]:
        return self._call('poll')

    def finish(self) -> List[Tuple[int, np.ndarray]]:
        """Two-phase close: queue the tail without flushing (it packs
        with other streams' traffic); ``poll`` / ``result`` until
        ``done``."""
        return self._call('finish')

    def close(self) -> List[Tuple[int, np.ndarray]]:
        """Synchronous close: pays a padded flush for immediacy."""
        out = self._call('close')
        self.done = True
        return out

    def result(self, poll_s: float = 0.02, timeout_s: float = 300.0
               ) -> np.ndarray:
        """Poll until the server reports the stream drained, then
        return the full (L, C) logits reassembled in frame order."""
        deadline = time.monotonic() + timeout_s
        while not self.done:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f'stream {self.sid} not drained after {timeout_s}s')
            self.poll()
            if not self.done:
                time.sleep(poll_s)
        if not self._pieces:
            return np.zeros((0, 0), np.float32)
        L = max(s + len(lg) for s, lg in self._pieces)
        out = np.full((L, self._pieces[0][1].shape[-1]), np.nan,
                      np.float32)
        for s, lg in self._pieces:
            out[s:s + len(lg)] = lg
        return out
