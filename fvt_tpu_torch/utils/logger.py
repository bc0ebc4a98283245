"""JSON-lines + text experiment logger: a copy of
``fvt_tpu/utils/logger.py`` less ``enable_jit_cache`` (XLA's compilation
cache; the port compiles nothing at run time but its kernels, which
``kernels/build.py`` keeps), held equal to it by
``tests/test_torch_copies.py``.

Keeps the upstream artifact contract — every experiment dir gets a
``log.json`` (one JSON object per line with elapsed time), a ``log.txt``
and mirrored stdout (its dllogger/logger.py:193-313,
parseit.py:414-423) — with a single small class instead of the dllogger
backend machinery.  Multi-process safe: only the initializing process
writes (worker processes inherit a no-op logger).
"""
from __future__ import annotations

import atexit
import io
import json
import os
import time
from datetime import datetime
from typing import Optional


class ExperimentLogger:
    def __init__(self, outd: Optional[str] = None, verbose: bool = True):
        self.verbose = verbose
        self.t0 = time.time()
        self.master_pid = os.getpid()
        self._json: Optional[io.TextIOBase] = None
        self._txt: Optional[io.TextIOBase] = None
        if outd is not None:
            os.makedirs(outd, exist_ok=True)
            self._json = open(os.path.join(outd, 'log.json'), 'a')
            self._txt = open(os.path.join(outd, 'log.txt'), 'a')

    def close(self):
        for f in (self._json, self._txt):
            if f is not None and not f.closed:
                f.close()
        self._json = self._txt = None

    def _is_master(self) -> bool:
        return os.getpid() == self.master_pid

    def log(self, message, step: Optional[int] = None):
        if not self._is_master():
            return
        elapsed = time.time() - self.t0
        stamp = datetime.now().isoformat(timespec='seconds')
        if self._json is not None:
            rec = {'t': stamp, 'elapsed': round(elapsed, 4), 'msg': message}
            if step is not None:
                rec['step'] = step
            self._json.write(json.dumps(rec, default=str) + '\n')
            self._json.flush()
        line = f"[{stamp} +{elapsed:9.2f}s] {message}"
        if self._txt is not None:
            self._txt.write(line + '\n')
            self._txt.flush()
        if self.verbose:
            print(line, flush=True)

    def metrics(self, data: dict, step: Optional[int] = None):
        self.log({'metrics': data}, step=step)

    def flush(self):
        for f in (self._json, self._txt):
            if f is not None and not f.closed:
                f.flush()


_LOGGER = ExperimentLogger(outd=None, verbose=True)
atexit.register(lambda: _LOGGER.flush())  # ONE callback; sees the
# current logger through the global, so replaced loggers are not
# pinned alive by atexit


def init_logger(outd: Optional[str], verbose: bool = True
                ) -> ExperimentLogger:
    """Install a fresh logger, CLOSING the previous one's file handles:
    long in-process sessions that drive many experiments (twin_train
    legs, repeated CLI invocations) would otherwise leak two fds per
    run."""
    global _LOGGER
    _LOGGER.close()
    _LOGGER = ExperimentLogger(outd=outd, verbose=verbose)
    return _LOGGER


def get_logger() -> ExperimentLogger:
    return _LOGGER


def log(message, step: Optional[int] = None):
    _LOGGER.log(message, step=step)


def fmsg(msg: str, sep: str = '=') -> str:
    """Banner formatting, same look as reference tools.fmsg."""
    bar = sep * 80
    return f"\n{bar}\n{msg}\n{bar}"

