"""A reader and a writer of flat YAML maps of scalars, without PyYAML.

``fvt_tpu`` writes a run's ``config.yml`` and a fold's ``class_id.yaml``
with ``yaml.dump`` and reads them with ``yaml.safe_load``; the port runs
where PyYAML is not installed.  Both files are one block map of scalars:
int, float, bool, null and str values under plain or quoted keys.

:func:`loads` takes what ``yaml.dump`` writes for such a map and gives what
``yaml.safe_load`` gives (YAML 1.1 resolution of plain scalars, as
PyYAML's resolver does it): ``true``/``false`` (and ``yes``/``no``/``on``/
``off``), ``null``/``~``/empty, ints (``0b``, ``0x``, octal, ``_``,
base 60), floats with a dot (``1.0e-07``, ``.inf``, ``.nan``), single-quoted
strings with ``''`` escapes, double-quoted strings with backslash escapes,
and plain or quoted scalars folded over indented continuation lines
(``yaml.dump`` wraps at 80 columns).  Anything else (a nested block, a
list, a flow collection, an anchor, a tag, a block scalar, a plain
timestamp) raises :class:`FlatYamlError` naming the line.

:func:`dumps` writes a map that both :func:`loads` and ``yaml.safe_load``
read back equal, keys sorted as ``yaml.dump`` sorts them.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

__all__ = ['FlatYamlError', 'loads', 'load', 'dumps', 'dump']


class FlatYamlError(ValueError):
    pass


# PyYAML's implicit resolvers (resolver.py), each with its first characters
_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False'
                   r'|FALSE|on|On|ON|off|Off|OFF)$')
_TRUE = {'yes', 'true', 'on'}
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
_TIMESTAMP = re.compile(
    r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X)
_FIRST = {  # resolver -> the first characters it is tried on
    'bool': set('yYnNtTfFoO'), 'float': set('-+0123456789.'),
    'int': set('-+0123456789'), 'null': set('~nN'),
    'timestamp': set('0123456789')}


def _sexagesimal(value: str, cast):
    sign = -1 if value.startswith('-') else 1
    out = cast(0)
    for part in value.lstrip('-+').split(':'):
        out = out * 60 + cast(part)
    return sign * out


def _int(value: str) -> int:
    v = value.replace('_', '')
    sign = -1 if v.startswith('-') else 1
    body = v.lstrip('-+')
    if body == '0':
        return 0
    if body.startswith('0b'):
        return sign * int(body[2:], 2)
    if body.startswith('0x'):
        return sign * int(body[2:], 16)
    if ':' in body:
        return _sexagesimal(v, int)
    if body.startswith('0'):
        return sign * int(body, 8)
    return sign * int(body)


def _float(value: str) -> float:
    v = value.replace('_', '').lower()
    sign = -1.0 if v.startswith('-') else 1.0
    body = v.lstrip('-+')
    if body == '.inf':
        return sign * math.inf
    if body == '.nan':
        return math.nan
    if ':' in body:
        return _sexagesimal(v, float)
    return sign * float(body)


def _resolve_plain(text: str, line: int) -> Any:
    """The value ``yaml.safe_load`` gives a plain scalar."""
    first = text[:1]
    if first in _FIRST['bool'] and _BOOL.match(text):
        return text.lower() in _TRUE
    if first in _FIRST['float'] and _FLOAT.match(text):
        return _float(text)
    if first in _FIRST['int'] and _INT.match(text):
        return _int(text)
    if (first in _FIRST['null'] or not text) and _NULL.match(text):
        return None
    if first in _FIRST['timestamp'] and _TIMESTAMP.match(text):
        raise FlatYamlError(f'line {line}: a plain timestamp ({text!r}) is '
                            f'not taken; quote it')
    if text in ('=', '<<'):
        raise FlatYamlError(f'line {line}: {text!r} is not taken')
    return text


_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t',
            'n': '\n', 'v': '\v', 'f': '\f', 'r': '\r', 'e': '\x1b',
            ' ': ' ', '"': '"', '/': '/', '\\': '\\', 'N': '\x85',
            '_': '\xa0', 'L': '\u2028', 'P': '\u2029'}
_HEX = {'x': 2, 'u': 4, 'U': 8}
_SENTINEL = 0xF0000  # plane 15, private use: never in a config


def _fold(lines: List[str]) -> str:
    """YAML's line folding of a flow scalar's lines: blanks around each
    break dropped, one break between two lines a space, each empty line
    between them a newline."""
    if len(lines) == 1:
        return lines[0]
    out, blanks = lines[0].rstrip(' \t'), 0
    for i, ln in enumerate(lines[1:], 2):
        ln = ln.lstrip(' \t') if i == len(lines) else ln.strip(' \t')
        if not ln and i < len(lines):
            blanks += 1
            continue
        out += ('\n' * blanks if blanks else ' ') + ln
        blanks = 0
    return out


def _single_quoted(lines: List[str], line: int) -> Tuple[str, str]:
    """(value, rest after the closing quote) of a scalar opened by ``'``
    at lines[0][0]."""
    text = '\n'.join(lines)[1:]
    i, parts = 0, []
    while True:
        j = text.find("'", i)
        if j < 0:
            raise FlatYamlError(f'line {line}: unterminated single-quoted '
                                f'scalar')
        if text[j + 1:j + 2] == "'":
            parts.append(text[i:j] + "'")
            i = j + 2
            continue
        parts.append(text[i:j])
        body, rest = ''.join(parts), text[j + 1:]
        return _fold(body.split('\n')), rest


def _double_quoted(lines: List[str], line: int) -> Tuple[str, str]:
    """(value, rest after the closing quote) of a scalar opened by ``"``.
    An escaped character is kept out of the folding (each stands in as a
    private-use character until the lines are folded); an escaped line
    break joins two lines with nothing between them."""
    text = '\n'.join(lines)[1:]
    out, escaped, i = [], [], 0
    while i < len(text):
        ch = text[i]
        if ch == '"':
            value = _fold(''.join(out).split('\n'))
            for k, c in enumerate(escaped):
                value = value.replace(chr(_SENTINEL + k), c)
            return value, text[i + 1:]
        if ch != '\\':
            out.append(ch)
            i += 1
            continue
        esc = text[i + 1:i + 2]
        if esc == '\n':
            i += 2
            while i < len(text) and text[i] in ' \t':
                i += 1
            continue
        if esc in _ESCAPES:
            c, i = _ESCAPES[esc], i + 2
        elif esc in _HEX:
            digits = text[i + 2:i + 2 + _HEX[esc]]
            if len(digits) != _HEX[esc] or not re.fullmatch(
                    r'[0-9a-fA-F]+', digits):
                raise FlatYamlError(f'line {line}: bad escape \\{esc}'
                                    f'{digits}')
            c, i = chr(int(digits, 16)), i + 2 + _HEX[esc]
        else:
            raise FlatYamlError(f'line {line}: unknown escape \\{esc}')
        out.append(chr(_SENTINEL + len(escaped)))
        escaped.append(c)
    raise FlatYamlError(f'line {line}: unterminated double-quoted scalar')


_NOT_PLAIN_START = set('[]{},#&*!|>%@`')


def _scalar(lines: List[str], line: int, what: str) -> Tuple[Any, str]:
    """Parses the scalar at the start of lines[0] (continued on the rest);
    returns (value, what follows it on its last line)."""
    text = lines[0]
    if text.startswith("'"):
        return _single_quoted(lines, line)
    if text.startswith('"'):
        return _double_quoted(lines, line)
    first = text[:1]
    if first in _NOT_PLAIN_START or (first in '-?:' and
                                     text[1:2] in ('', ' ')):
        raise FlatYamlError(f'line {line}: {what} {text!r} is not a scalar '
                            f'this reader takes (a list, a flow '
                            f'collection, an anchor, a tag, a block scalar '
                            f'or a nested map)')
    parts = []
    for ln in lines:
        cut = ln.find(' #')
        if cut >= 0:  # a comment ends the scalar
            parts.append(ln[:cut])
            break
        parts.append(ln)
    value = _fold(parts).strip(' \t')
    if ': ' in value or value.endswith(':'):
        raise FlatYamlError(f'line {line}: ": " inside the plain {what} '
                            f'{value!r}')
    return _resolve_plain(value, line), ''


def _split_key(text: str, line: int) -> Tuple[Any, str]:
    """(key, the text after ``:``) of a map entry's first line."""
    if text[:1] in ('"', "'"):
        key, rest = _scalar([text], line, 'key')
        if not (rest.startswith(': ') or rest == ':'):
            raise FlatYamlError(f'line {line}: expected ":" after the key')
        return key, rest[1:]
    m = re.search(r':(?: |$)', text)
    if m is None:
        raise FlatYamlError(f'line {line}: not a "key: value" entry: '
                            f'{text!r}')
    key, _ = _scalar([text[:m.start()]], line, 'key')
    return key, text[m.end():]


def loads(text: str) -> Dict[Any, Any]:
    """The flat map in ``text``, as ``yaml.safe_load`` reads it."""
    raw = text.split('\n')
    entries: List[Tuple[int, List[str]]] = []  # (line number, its lines)
    for n, ln in enumerate(raw, 1):
        if any(c in ln for c in '\x85\u2028\u2029'):
            raise FlatYamlError(f'line {n}: a unicode line break (NEL, LS '
                                f'or PS) is not taken')
        if '\t' in ln[:len(ln) - len(ln.lstrip())]:
            raise FlatYamlError(f'line {n}: a tab in the indentation')
        stripped = ln.strip()
        if not stripped and not entries:
            continue
        if stripped.startswith('#') and (not entries or ln[:1] == '#'):
            continue
        if ln[:1] not in (' ', '') and stripped:
            if stripped == '{}' and not entries:
                entries.append((n, ['{}']))
                continue
            if stripped in ('---', '...'):
                raise FlatYamlError(f'line {n}: one document without '
                                    f'markers is taken')
            entries.append((n, [ln]))
        elif entries:
            entries[-1][1].append(ln)
        else:
            raise FlatYamlError(f'line {n}: indented text before any key')
    out: Dict[Any, Any] = {}
    if len(entries) == 1 and entries[0][1][0].strip() == '{}':
        return out
    for n, lines in entries:
        key, rest = _split_key(lines[0], n)
        body = [rest.lstrip(' ')] + lines[1:]
        while body and not body[-1].strip():
            body.pop()
        if not body or (not body[0].strip() and len(body) == 1):
            value, tail = None, ''
        elif not body[0].strip():
            raise FlatYamlError(f'line {n}: a nested block under {key!r} is '
                                f'not taken: only a flat map of scalars')
        else:
            value, tail = _scalar(body, n, 'value')
        tail = tail.strip(' \t\n')
        if tail and not tail.startswith('#'):
            raise FlatYamlError(f'line {n}: text after the value of '
                                f'{key!r}: {tail!r}')
        if key in out:
            raise FlatYamlError(f'line {n}: key {key!r} repeated')
        out[key] = value
    return out


def load(path: str) -> Dict[Any, Any]:
    with open(path, 'r') as f:
        return loads(f.read())


def _float_text(v: float) -> str:
    if math.isnan(v):
        return '.nan'
    if math.isinf(v):
        return '.inf' if v > 0 else '-.inf'
    s = repr(v).lower()
    if '.' not in s and 'e' in s:  # YAML 1.1 floats need a dot
        s = s.replace('e', '.0e', 1)
    return s


def _str_text(v: str) -> str:
    printable = all(' ' <= c <= '~' for c in v)
    if printable and v and v == v.strip(' ') and v[0] not in \
            _NOT_PLAIN_START | set('\'"-?:') and ': ' not in v \
            and ' #' not in v and not v.endswith(':'):
        try:
            if _resolve_plain(v, 0) == v:
                return v
        except FlatYamlError:
            pass
    if printable:
        return "'" + v.replace("'", "''") + "'"
    out = []
    for c in v:
        if c in '"\\':
            out.append('\\' + c)
        elif ' ' <= c <= '~':
            out.append(c)
        elif ord(c) <= 0xff:
            out.append(f'\\x{ord(c):02X}')
        elif ord(c) <= 0xffff:
            out.append(f'\\u{ord(c):04X}')
        else:
            out.append(f'\\U{ord(c):08X}')
    return '"' + ''.join(out) + '"'


def _scalar_text(v: Any) -> str:
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        return _str_text(v)
    raise TypeError(f'{type(v).__name__} is not a scalar this writer takes')


def dumps(data: Dict[Any, Any]) -> str:
    """``data`` as a flat YAML map, keys sorted."""
    if not data:
        return '{}\n'
    return ''.join(f'{_scalar_text(k)}: {_scalar_text(data[k])}\n'
                   for k in sorted(data))


def dump(data: Dict[Any, Any], path: str) -> None:
    with open(path, 'w') as f:
        f.write(dumps(data))
