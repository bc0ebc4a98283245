"""Serving endpoint over a frozen ``.fvtserve`` artifact (``tools/
serve_http.py`` of ``fvt_tpu``), built on ``fvt_tpu_torch.export.
load_artifact`` and the server core of ``fvt_tpu_torch.streaming``.
Stdlib HTTP (``http.server``), one process, one card.

    python -m fvt_tpu_torch.tools.serve_http --artifact run/serving.fvtserve \\
        [--host 127.0.0.1] [--port 8700] [--device cpu] [--mesh N] \\
        [--dynamic_batch] [--batch_delay_ms 50] [--session_ttl_s 3600] \\
        [--max_sessions 0] [--drain_timeout_s 30] [--fd_exp <training-run-dir>]

The model runs on the card unless ``--device cpu`` is given (``fvt_tpu``'s
``--force_cpu``).  An artifact that ``fvt_tpu`` exported carries no
``model_args``: ``--fd_exp`` names the run whose ``config.yml`` builds its
model.  An int8 or ``int8_static`` artifact serves through the int8
ArcFace; one of ``--h2d_bf16_features`` takes its feature streams as
float32 (rounded to bfloat16 here) or as bfloat16 bits (uint16).
``--mesh N`` (N >= 1) serves data-parallel over N ranks, ``fvt_tpu``'s
``call_sharded``: this process is rank 0 on ``cuda:0`` and N - 1 follower
processes hold the same artifact on ``cuda:1`` ... (``--device cpu``: N
``gloo`` ranks on the CPU; N above the visible cards is refused); each
batch's rows are split over them (``parallel/serving.py``), a batch whose
rows N does not divide is answered 400, and drain or shutdown stops the
followers.  ``fvt_tpu_torch/client.py`` speaks this protocol.

Protocol:
  GET  /healthz       -> {"ok": true, "shapes": [...], "aot": false,
                          "mesh": N, session/batching counters, drain
                          state, per-endpoint latency percentiles}
  GET  /metrics       -> the same counters in Prometheus text format
  GET  /meta          -> the artifact's meta.json
  POST /logits        -> body: npz (numpy savez) with one array per
                         modality [+ optional 'length' (B,) int32 for
                         JMT and MT]; response: npz {'logits': (B,T,C)}.
                         The batch shape must be one of the artifact's
                         (a miss, or rows that --mesh N does not
                         divide, comes back as 400 with its shapes;
                         a failed forward, a CUDA or kernel error, as
                         500).

Streaming (per-frame logits finalised as soon as no later window can
cover them, bit for bit the offline stitch):
  POST /stream/open        -> {"sid": "..."}
  POST /stream/<sid>/feed  -> body: npz, one (n, ...) array per
                              modality (any chunk length, 1 frame up);
                              response: npz {'start': i, 'logits':
                              (m, C)}: the frames finalised so far.
  POST /stream/<sid>/poll  -> empty body; the same response and a
                              'done' flag: frames finalised since the
                              last feed or poll.
  POST /stream/<sid>/finish-> two-phase close: queues the tail without
                              flushing it (poll until 'done'; the stale
                              flush bounds the wait).
  POST /stream/<sid>/close -> synchronous: flushes the tail window; the
                              same response; the session is gone
                              afterwards (404).

``--dynamic_batch`` packs ready windows of all live streams into shared
full window_batch dispatches (LFAN and CAN only: JMT's and MT's final
attention mixes the batch's rows, so they are refused);
``--batch_delay_ms`` bounds the wait before a partial batch is flushed.
``--session_ttl_s`` expires sessions idle that long (0 = never);
``--max_sessions`` refuses ``/stream/open`` with 503 beyond that many
live sessions.  SIGTERM or SIGINT drain: new opens are refused while
live streams finish, bounded by ``--drain_timeout_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import signal
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fvt_tpu_torch.export import load_artifact, load_run_config
from fvt_tpu_torch.parallel import serving
from fvt_tpu_torch.streaming import CapacityError, StreamingRegistry
from fvt_tpu_torch.utils import bf16


class LatencyStats:
    """Per-endpoint request latencies for /healthz: a bounded ring of
    recent durations per endpoint, so the percentiles follow the current
    load.  Thread-safe."""

    RING = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._by_ep = {}  # endpoint -> (count, ring list)

    def record(self, endpoint: str, seconds: float) -> None:
        with self._lock:
            count, ring = self._by_ep.get(endpoint, (0, []))
            ring.append(seconds)
            if len(ring) > self.RING:
                del ring[:len(ring) - self.RING]
            self._by_ep[endpoint] = (count + 1, ring)

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for ep, (count, ring) in self._by_ep.items():
                r = sorted(ring)

                def q(p):
                    return round(r[min(len(r) - 1, int(len(r) * p))] * 1e3,
                                 3)

                out[ep] = {'count': count, 'p50_ms': q(0.5),
                           'p95_ms': q(0.95), 'p99_ms': q(0.99),
                           'max_ms': round(r[-1] * 1e3, 3)}
            return out


def _npz(body: bytes) -> dict:
    """The arrays of an npz request body; ValueError if it is none."""
    try:
        with np.load(io.BytesIO(body)) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:
        raise ValueError(f'malformed npz body: {type(e).__name__}: '
                         f'{e}') from e


def make_handler(art, world=None, dynamic_batch=False, batch_delay_s=0.05,
                 session_ttl_s=3600.0, max_sessions=0):
    """The request handler of ``art``, served data-parallel over ``world``
    (``call_sharded``) where one is given."""
    streams = StreamingRegistry(art, mesh=world, dynamic_batch=dynamic_batch,
                                max_delay_s=batch_delay_s,
                                session_ttl_s=session_ttl_s,
                                max_sessions=max_sessions)
    latency = LatencyStats()

    def dispatch(arrays, length=None):
        if world is not None:
            return art.call_sharded(arrays, mesh=world, length=length)
        return art.call(arrays, length=length)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload, ctype='application/json'):
            body = payload if isinstance(payload, bytes) \
                else json.dumps(payload).encode()
            self._record()
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _metrics_text(self) -> str:
            b = streams.batcher
            lines = [
                '# fvt_tpu_torch serving metrics (Prometheus text format)',
                f'fvt_live_sessions {streams.live_sessions}',
                f'fvt_expired_sessions_total {streams.expired_sessions}',
                f'fvt_rejected_sessions_total '
                f'{streams.rejected_sessions}',
                f'fvt_draining {int(streams.draining)}',
            ]
            if b is not None:
                lines += [
                    f'fvt_stream_dispatches_total {b.dispatches}',
                    f'fvt_stream_rows_padded_total {b.rows_padded}',
                ]
            for ep, row in latency.snapshot().items():
                lab = f'{{endpoint="{ep}"}}'
                lines.append(f'fvt_request_count_total{lab} {row["count"]}')
                for q in ('0.5', '0.95', '0.99'):
                    key = f'p{int(float(q) * 100)}_ms'
                    lines.append(f'fvt_request_latency_ms{{endpoint="{ep}",'
                                 f'quantile="{q}"}} {row[key]}')
            return '\n'.join(lines) + '\n'

        def do_GET(self):
            if self.path == '/metrics':
                self._send(200, self._metrics_text().encode(),
                           ctype='text/plain; version=0.0.4')
            elif self.path == '/healthz':
                b = streams.batcher
                self._send(200, {'ok': True, 'shapes': art.shape_keys,
                                 'aot': False,
                                 'mesh': 0 if world is None else world.size,
                                 'dynamic_batch': b is not None,
                                 'stream_dispatches':
                                     b.dispatches if b else None,
                                 'stream_rows_padded':
                                     b.rows_padded if b else None,
                                 'live_sessions': streams.live_sessions,
                                 'expired_sessions':
                                     streams.expired_sessions,
                                 'rejected_sessions':
                                     streams.rejected_sessions,
                                 'draining': streams.draining,
                                 'latency': latency.snapshot()})
            elif self.path == '/meta':
                self._send(200, art.meta)
            else:
                self._send(404, {'error': f'unknown path {self.path}'})

        def _send_stream(self, start, logits, done=None):
            buf = io.BytesIO()
            extra = {} if done is None else {'done': np.bool_(done)}
            np.savez(buf, start=np.int64(start),
                     logits=np.asarray(logits, np.float32), **extra)
            self._send(200, buf.getvalue(),
                       ctype='application/octet-stream')

        def _record(self):
            """Records a POST's latency before its response leaves, so
            that the client's next request (/healthz) already counts
            it."""
            t0, self._t0 = getattr(self, '_t0', None), None
            if t0 is None:
                return
            parts = self.path.strip('/').split('/')
            ep = (f'/stream/{parts[2]}' if len(parts) == 3
                  and parts[0] == 'stream' else self.path)
            latency.record(ep, time.monotonic() - t0)

        def do_POST(self):
            self._t0 = time.monotonic()
            try:
                self._do_post()
            finally:
                self._record()  # where no response was sent

        def _do_post(self):
            n = int(self.headers.get('Content-Length', 0))
            body = self.rfile.read(n)
            parts = self.path.strip('/').split('/')
            try:
                if self.path == '/logits':
                    arrays = _npz(body)
                    length = arrays.pop('length', None)
                    out = dispatch(arrays, length=length)
                    buf = io.BytesIO()
                    np.savez(buf, logits=out)
                    self._send(200, buf.getvalue(),
                               ctype='application/octet-stream')
                elif self.path == '/stream/open':
                    try:
                        self._send(200, {'sid': streams.open()})
                    except CapacityError as e:
                        self._send(503, {'error': str(e)})
                elif (len(parts) == 3 and parts[0] == 'stream'
                        and parts[2] in ('feed', 'poll', 'finish',
                                         'close')):
                    sid = parts[1]
                    done = None
                    try:
                        if parts[2] == 'feed':
                            start, logits = streams.feed(sid, _npz(body))
                        elif parts[2] == 'poll':
                            start, logits, done = streams.poll(sid)
                        elif parts[2] == 'finish':
                            start, logits, done = streams.finish(sid)
                        else:
                            start, logits = streams.close(sid)
                            done = True
                    except KeyError:
                        self._send(404, {'error': f'no session {sid!r}'})
                        return
                    self._send_stream(start, logits, done=done)
                else:
                    self._send(404,
                               {'error': f'unknown path {self.path}'})
            except (KeyError, AssertionError, ValueError) as e:
                # a malformed body, a shape the artifact does not serve,
                # rows the mesh does not divide, a length given to a model
                # without a mask, or a malformed stream chunk
                self._send(400, {'error': str(e),
                                 'shapes': art.shape_keys})
            except Exception as e:
                # the forward failed (a CUDA or kernel error), not the
                # request: a server error, logged
                traceback.print_exc()
                self._send(500, {'error': f'{type(e).__name__}: {e}'})

        def log_message(self, fmt, *a):  # quiet unless asked
            if os.environ.get('FVT_SERVE_VERBOSE'):
                super().log_message(fmt, *a)

    Handler.streams = streams
    return Handler


def build_server(artifact: str, host: str = '127.0.0.1', port: int = 0,
                 device=None, mesh_devices: int = 0,
                 dynamic_batch: bool = False, batch_delay_s: float = 0.05,
                 session_ttl_s: float = 3600.0,
                 max_sessions: int = 0,
                 config=None, world=None) -> ThreadingHTTPServer:
    """The server of ``artifact`` on ``device`` (None: the card), every
    shape warmed by one call, not yet serving (``serve_forever``);
    ``config``, the run's config, builds an artifact without
    ``model_args`` (``export.model_args``).  ``mesh_devices`` N >= 1 serves
    over N ranks that this call starts (``serving.start``), ``world`` over
    a group the caller joined as its rank 0 (the other ranks follow:
    ``serving.follow``); :func:`drain_and_shutdown` stops the followers
    and ends a group it started."""
    group = None
    if world is None and mesh_devices:
        group = serving.start(artifact, mesh_devices, device, config)
        art, world = group.art, group.world
    else:
        art = load_artifact(artifact, device=device, config=config)
    try:
        if dynamic_batch and art.needs_mask:
            raise ValueError(f'--dynamic_batch: {art.meta["model_name"]}\'s '
                             f'final attention mixes the batch\'s rows, so '
                             f'its streams cannot share a dispatch (LFAN and '
                             f'CAN only)')
        for key in art.shape_keys:
            shape = art.meta['shapes'][key]
            batch = {k: np.zeros(v['shape'], bf16.numpy_dtype(v['dtype']))
                     for k, v in shape['inputs'].items()}
            if world is None:
                art.call(batch)
            elif shape['window_batch'] % world.size == 0:
                art.call_sharded(batch, mesh=world)
        handler = make_handler(art, world, dynamic_batch=dynamic_batch,
                               batch_delay_s=batch_delay_s,
                               session_ttl_s=session_ttl_s,
                               max_sessions=max_sessions)
        srv = ThreadingHTTPServer((host, port), handler)
    except BaseException:
        if group is not None:
            with contextlib.suppress(Exception):
                group.close()
        raise
    srv.streams = handler.streams
    srv.artifact = art
    srv.world, srv.group = world, group
    return srv


def drain_and_shutdown(srv, timeout_s: float = 30.0,
                       poll_s: float = 0.1) -> int:
    """Refuses new stream opens (503) while live streams keep feeding,
    finishing and polling, waits until none remain or ``timeout_s``, then
    stops the server and the serving group's followers.  Returns the
    sessions abandoned at the deadline."""
    live = srv.streams.drain()
    print(f'draining: {live} live sessions, opens now refused',
          flush=True)
    deadline = time.monotonic() + timeout_s
    while srv.streams.live_sessions and time.monotonic() < deadline:
        time.sleep(poll_s)
    left = srv.streams.live_sessions
    srv.shutdown()
    srv.server_close()
    srv.streams.stop()
    if srv.group is not None:
        srv.group.close()
    elif srv.world is not None:
        srv.artifact.stop_followers(srv.world)
    if left:
        print(f'drain deadline hit: {left} sessions abandoned',
              flush=True)
    return left


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--artifact', required=True)
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8700,
                   help='0: a port the system picks as the server binds '
                        'it, named in the "serving ... on '
                        'http://host:port" line')
    p.add_argument('--device', default=None,
                   help='torch device (default: the card; cpu to serve on '
                        'the CPU)')
    p.add_argument('--fd_exp', default=None,
                   help="the training run dir whose config.yml builds an "
                        "artifact without model_args (fvt_tpu's)")
    p.add_argument('--mesh', type=int, default=0,
                   help='serve data-parallel over N ranks, one a card '
                        '(0 = in process, no group)')
    p.add_argument('--dynamic_batch', action='store_true',
                   help='pack windows from all live streams into shared '
                        'full window_batch dispatches (LFAN, CAN)')
    p.add_argument('--batch_delay_ms', type=float, default=50.0,
                   help='max wait before a partial window batch is '
                        'flushed')
    p.add_argument('--session_ttl_s', type=float, default=3600.0,
                   help='expire streaming sessions idle this long '
                        '(0 = never)')
    p.add_argument('--max_sessions', type=int, default=0,
                   help='refuse /stream/open (503) beyond this many '
                        'live sessions (0 = unlimited)')
    p.add_argument('--drain_timeout_s', type=float, default=30.0,
                   help='on SIGTERM/SIGINT: refuse new opens and wait '
                        'this long for live streams to finish')
    a = p.parse_args(argv)
    if a.dynamic_batch and a.batch_delay_ms <= 0:
        p.error('--dynamic_batch needs --batch_delay_ms > 0: with no '
                'stale-flush bound, a lone stream\'s finished tail is '
                'dispatched only by other streams\' traffic')
    srv = build_server(a.artifact, a.host, a.port, device=a.device,
                       mesh_devices=a.mesh, dynamic_batch=a.dynamic_batch,
                       batch_delay_s=a.batch_delay_ms / 1000.0,
                       session_ttl_s=a.session_ttl_s,
                       max_sessions=a.max_sessions,
                       config=(load_run_config(a.fd_exp) if a.fd_exp
                               else None))
    print(f'serving {a.artifact} on http://{a.host}:{srv.server_port} '
          f'(shapes warmed)', flush=True)
    stop = threading.Event()

    def on_signal(signum, frame):
        if stop.is_set():
            # a second signal while draining: the default action
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    stop.wait()
    drain_and_shutdown(srv, timeout_s=a.drain_timeout_s)
    server_thread.join(timeout=10)


if __name__ == '__main__':
    main(sys.argv[1:])
