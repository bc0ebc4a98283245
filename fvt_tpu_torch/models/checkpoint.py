"""Best models of a run in ``fvt_tpu``'s format: read into the port's
LFAN, CAN, JMT or MT, and written from it.

``fvt_tpu`` saves ``best-models/<case>/model.msgpack`` with flax's
``serialization.to_bytes`` over ``{'params', 'batch_stats'}``: a msgpack
map of str keys whose leaves are numpy arrays packed as msgpack ExtType 1
(``(shape, dtype name, C-order bytes)``, flax's ``_ndarray_to_bytes``) or
numpy scalars as ExtType 3 (the same payload, 0-d).  The machine the port
runs on has neither flax nor the ``msgpack`` package, so
:func:`msgpack_restore` reads that format in plain Python and gives what
``flax.serialization.msgpack_restore`` gives.  Arrays above 1 GB, which
flax writes in chunks (``__msgpack_chunked_array__``), raise: no model of
the repo has one (the largest, the VGGish's ``fc0`` kernel of a ``logmel``
model, is 201 MB).

:func:`load_best_model` takes that file through
``from_jax.state_from_flax``, or an upstream ``model.pt`` through
``torch.load`` with the dead keys of the model's family dropped
(``from_jax.is_dead_key``), and loads the state_dict with
``strict=True`` (the counterpart of ``fvt_tpu``'s
``Trainer.load_best_model`` and ``Experiment._load_torch_ckpt``).

:func:`msgpack_dumps` is the writer of that format, the inverse of
:func:`msgpack_restore`: what ``msgpack.packb(tree, default=flax's ext
packer, strict_types=True)`` gives, byte for byte (every ndarray as
ExtType 1 over the msgpack of ``(shape, dtype name, C-order bytes)``,
numpy scalars as ExtType 3, each int and length in its smallest msgpack
form, Python floats as float64).  Dicts are packed in their own order;
nothing is chunked, as flax chunks only arrays above 1 GB.
:func:`save_best_model` writes ``{'params', 'batch_stats'}`` from
``to_jax.flax_from_state``, whose trees are keyed in sorted order
as ``fvt_tpu``'s ``jax.tree.map`` leaves them: the bytes of
``flax.serialization.to_bytes`` in ``fvt_tpu``'s ``Trainer.optimize``.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.models.from_jax import is_dead_key, state_from_flax
from fvt_tpu_torch.models.to_jax import flax_from_state

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = '__msgpack_chunked_array__'


class MsgpackError(ValueError):
    pass


class _Reader:
    """A msgpack decoder over ``data``; ``raw`` keeps str as bytes (flax
    decodes an array's payload so)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError(f'truncated at byte {self.pos}')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode('utf-8')

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise MsgpackError(f'msgpack ExtType {code} is not a flax type')

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
                 0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
                 0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
                 0xde: ('map', '>H'), 0xdf: ('map', '>I')}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
                   0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            code = self.unpack('>b')
            return self.ext(code, fixext[b])
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
            return self.ext(self.unpack('>b'), n)
        raise MsgpackError(f'byte 0x{b:02x} at {self.pos - 1} is no msgpack '
                           f'type')

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    reader = _Reader(payload, raw=True)
    shape, name, buffer = reader.value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == 'bfloat16':  # widened exactly: bf16 is fp32's top half
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape,
                                                               order='C')


def _refuse_chunks(tree: Any, path: str = '') -> None:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            raise MsgpackError(f'{path or "the root"}: a chunked array '
                               f'(above 1 GB) is not read')
        for k, v in tree.items():
            _refuse_chunks(v, f'{path}/{k}')


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives: nested
    dicts of numpy arrays (read-only views of ``data``) and scalars."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise MsgpackError(f'{len(reader.data) - reader.pos} bytes after the '
                           f'object')
    _refuse_chunks(tree)
    return tree


def read_flax_variables(path: str) -> Tuple[dict, dict]:
    """(params, batch_stats) of a ``model.msgpack``."""
    with open(path, 'rb') as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict) or 'params' not in tree:
        raise MsgpackError(f'{path}: no params tree')
    return tree['params'], tree.get('batch_stats', {})


def load_best_model(model: nn.Module, path: str,
                    modality: Sequence[str]) -> None:
    """Loads ``path`` (``model.msgpack`` of ``fvt_tpu``, or an upstream
    ``model.pt``) into the port's ``model`` (LFAN, CAN, JMT or MT) with
    ``strict=True``.  ``modality``: the model's modality order, leader
    first."""
    if path.endswith('.msgpack'):
        state = state_from_flax(*read_flax_variables(path), modality)
    else:
        name = getattr(model, 'model_name', constants.LFAN)
        sd = torch.load(path, map_location='cpu')
        state = {k: v for k, v in sd.items() if not is_dead_key(k, name)}
    model.load_state_dict(state, strict=True)


def _head(out: bytearray, n: int, fix: int, fix_max: int,
          wide: Sequence[Tuple[int, str]]) -> None:
    """A length or count ``n``: in the fix byte up to ``fix_max``, else
    after the first code of ``wide`` whose format holds it."""
    if fix_max and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f'{n} is too long for msgpack')


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out += struct.pack('>b' if v < 0 else '>B', v)
        return
    kinds = (((0xcc, '>B'), (0xcd, '>H'), (0xce, '>I'), (0xcf, '>Q'))
             if v >= 0 else
             ((0xd0, '>b'), (0xd1, '>h'), (0xd2, '>i'), (0xd3, '>q')))
    for code, fmt in kinds:
        try:
            packed = struct.pack(fmt, v)
        except struct.error:
            continue
        out.append(code)
        out += packed
        return
    raise MsgpackError(f'{v} does not fit msgpack\'s 64-bit ints')


def _ext(out: bytearray, code: int, payload: bytes) -> None:
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _head(out, len(payload), 0, 0, ((0xc7, '>B'), (0xc8, '>H'),
                                         (0xc9, '>I')))
    out += struct.pack('>b', code)
    out += payload


def _ndarray_bytes(a: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise MsgpackError('object and structured dtypes are not written')
    return msgpack_dumps([list(a.shape), a.dtype.name, a.tobytes('C')])


def _pack(v: Any, out: bytearray) -> None:
    if isinstance(v, np.ndarray):
        _ext(out, EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    elif v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif type(v) is int:
        _int(out, v)
    elif type(v) is float:
        out.append(0xcb)
        out += struct.pack('>d', v)
    elif type(v) is str:
        b = v.encode('utf-8')
        _head(out, len(b), 0xa0, 31, ((0xd9, '>B'), (0xda, '>H'),
                                       (0xdb, '>I')))
        out += b
    elif type(v) is bytes:
        _head(out, len(v), 0, 0, ((0xc4, '>B'), (0xc5, '>H'), (0xc6, '>I')))
        out += v
    elif type(v) is list:
        _head(out, len(v), 0x90, 15, ((0xdc, '>H'), (0xdd, '>I')))
        for item in v:
            _pack(item, out)
    elif type(v) is dict:
        _head(out, len(v), 0x80, 15, ((0xde, '>H'), (0xdf, '>I')))
        for k, item in v.items():
            _pack(k, out)
            _pack(item, out)
    else:
        raise MsgpackError(f'{type(v).__name__} is not written')


def msgpack_dumps(tree: Any) -> bytes:
    """``tree`` (dicts, lists, str, bytes, int, float, bool, None, numpy
    arrays and scalars) in flax's msgpack."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def save_best_model(model: Union[nn.Module, Mapping[str, torch.Tensor]],
                    path: str, modality: Sequence[str]) -> None:
    """Writes ``model`` (the port's LFAN, CAN, JMT or MT, or its
    state_dict) as ``fvt_tpu``'s ``model.msgpack`` at ``path``, which
    ``fvt_tpu``'s ``Trainer.load_best_model`` and :func:`load_best_model`
    read.  ``modality``: the model's modality order, leader first."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    params, stats = flax_from_state(state, modality)
    blob = msgpack_dumps({'params': params, 'batch_stats': stats})
    tmp = f'{path}.tmp'
    with open(tmp, 'wb') as f:
        f.write(blob)
    os.replace(tmp, path)
