# pixelrec_multimodal_tpu_torch/utils/yaml_io.py
"""A YAML reader and writer for configuration files, with no PyYAML.

The reader covers what ``yaml.safe_load`` reads in the repo's config files
and in what ``Config.to_yaml`` writes: block mappings and sequences
(nested, a sequence under a key at the key's indentation or deeper,
``- - x`` and ``- key: value``), one-line flow sequences and mappings
(``[a, b]``, ``{}``), single- and double-quoted scalars, ``#`` comments and
a leading ``---``. Plain scalars resolve as PyYAML's YAML 1.1 resolver
resolves them, quirks included: ``1e-4`` (no point) is the string
``'1e-4'``, ``1.0e-06`` a float, ``yes``/``on`` True, ``017`` is 15,
``1_000`` is 1000, ``1:30`` is 90, ``~`` and ``null`` None. Anything else
(anchors and aliases, tags, block and multi-line scalars, complex keys,
timestamps, merge keys, multi-line flow collections) raises ValueError
naming the line: it is never read wrongly.

The writer writes mappings, lists and scalars in PyYAML's block layout
(``dump(..., default_flow_style=False, sort_keys=False)``), and quotes a
string whenever it would otherwise read back as another type, so that
both this reader and ``yaml.safe_load`` read it back to the same value.
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, List, Tuple, Union

# PyYAML's implicit resolvers (yaml/resolver.py), in its order, keyed by
# the first characters each applies to.
_BOOL_RE = re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X)
_FLOAT_RE = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT_RE = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_MERGE_RE = re.compile(r'^(?:<<)$')
_NULL_RE = re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X)
_TIMESTAMP_RE = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                           re.X)
_VALUE_RE = re.compile(r'^(?:=)$')
_RESOLVERS = (
    ('bool', _BOOL_RE, 'yYnNtTfFoO'),
    ('float', _FLOAT_RE, '-+0123456789.'),
    ('int', _INT_RE, '-+0123456789'),
    ('merge', _MERGE_RE, '<'),
    ('null', _NULL_RE, '~nN'),
    ('timestamp', _TIMESTAMP_RE, '0123456789'),
    ('value', _VALUE_RE, '='),
)
_BOOLS = {'yes': True, 'no': False, 'true': True, 'false': False,
          'on': True, 'off': False}
# Characters that start something other than a plain scalar.
_INDICATORS = set('-?:,[]{}#&*!|>\'"%@`')
_DOUBLE_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t',
                   'n': '\n', 'v': '\v', 'f': '\f', 'r': '\r', 'e': '\x1b',
                   ' ': ' ', '"': '"', '/': '/', '\\': '\\', 'N': '\x85',
                   '_': '\xa0', 'L': '\u2028', 'P': '\u2029'}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(':')):
        total += cast(part) * base
        base *= 60
    return total


def _resolve_kind(value: str) -> str:
    """The tag PyYAML's resolver gives a plain scalar ('str' if none)."""
    first = value[0] if value else ''
    for kind, regex, firsts in _RESOLVERS:
        if (first in firsts if first else kind == 'null') \
                and regex.match(value):
            return kind
    return 'str'


def resolve_plain(value: str, where: str = '<yaml>') -> Any:
    """A plain scalar's value, as ``yaml.safe_load`` constructs it."""
    kind = _resolve_kind(value)
    if kind == 'str':
        return value
    if kind == 'null':
        return None
    if kind == 'bool':
        return _BOOLS[value.lower()]
    if kind in ('timestamp', 'merge', 'value'):
        raise ValueError(f'{where}: {value!r} is a YAML {kind}, which this '
                         'reader does not take; quote it for a string')
    v = value.replace('_', '')
    sign = -1 if v[0] == '-' else 1
    if v[0] in '+-':
        v = v[1:]
    if kind == 'float':
        v = v.lower()
        if v == '.inf':
            return sign * math.inf
        if v == '.nan':
            return math.nan
        if ':' in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if v == '0':
        return 0
    if v.startswith('0b'):
        return sign * int(v[2:], 2)
    if v.startswith('0x'):
        return sign * int(v[2:], 16)
    if v[0] == '0':
        return sign * int(v, 8)
    if ':' in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


# ------------------------------------------------------------------ reader
class _Line:
    __slots__ = ('indent', 'text', 'number')

    def __init__(self, indent: int, text: str, number: int):
        self.indent, self.text, self.number = indent, text, number


def _strip_comment(text: str) -> str:
    """The line without its comment: a '#' at the start or after
    whitespace, outside a quoted scalar. A quote opens a quoted scalar
    only where a scalar starts (the line's start, after ``key: ``, ``- ``,
    or after ``[``, ``{`` or ``,`` inside a flow collection); inside a
    plain scalar it is a character like any other."""
    quote = None
    depth = 0
    i = 0
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
            elif quote == '"' and ch == '\\':
                i += 1
        else:
            before = text[:i].rstrip(' ')
            spaced = len(before) < i
            starts = (not before or (before[-1] == ':' and spaced)
                      or (set(before) <= set('- ') and spaced)
                      or (depth > 0 and before[-1] in '[{,'))
            if ch in '\'"' and starts:
                quote = ch
            elif ch in '[{' and (starts or depth > 0):
                depth += 1
            elif ch in ']}' and depth > 0:
                depth -= 1
            elif ch == '#' and (i == 0 or text[i - 1] in ' \t'):
                return text[:i].rstrip()
        i += 1
    return text.rstrip()


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: List[_Line] = []
        for number, raw in enumerate(text.splitlines(), start=1):
            body = raw.lstrip(' ')
            if body.startswith('\t'):
                self.fail(number, 'a tab in the indentation')
            body = _strip_comment(body)
            if not body:
                continue
            self.lines.append(_Line(len(raw) - len(raw.lstrip(' ')), body,
                                    number))
        if self.lines and self.lines[0].indent == 0 and \
                self.lines[0].text == '---':
            self.lines.pop(0)
        for line in self.lines:
            if line.text.startswith(('---', '...', '%')) and \
                    line.indent == 0:
                self.fail(line.number, 'documents and directives are '
                          'outside this reader\'s subset')

    def fail(self, number: int, what: str):
        raise ValueError(f'{self.source}:{number}: {what}')

    # ---------------------------------------------------------- documents
    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0].indent)
        if i < len(self.lines):
            self.fail(self.lines[i].number, 'unexpected indentation')
        return value

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if self.is_item(line.text):
            return self.sequence(i, indent)
        if self.key_split(line) is not None:
            return self.mapping(i, indent)
        value = self.inline(line.text, line.number)
        if i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
            self.fail(self.lines[i + 1].number, 'a multi-line scalar is '
                      'outside this reader\'s subset')
        return value, i + 1

    @staticmethod
    def is_item(text: str) -> bool:
        return text == '-' or text.startswith('- ')

    def nested(self, i: int, indent: int, same_level_seq: bool
               ) -> Tuple[Any, int]:
        """The value of a key or item whose line ends after its
        indicator: the deeper block below it (or, for a key, a sequence at
        its own indentation), else null."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > indent:
                return self.block(i, nxt.indent)
            if same_level_seq and nxt.indent == indent and \
                    self.is_item(nxt.text):
                return self.sequence(i, indent)
        return None, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i].indent == indent and \
                self.is_item(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:].lstrip(' ')
            if not rest:
                value, i = self.nested(i + 1, indent, False)
            else:
                # The rest of the line is a block of its own, indented to
                # where it starts (``- - x``, ``- key: value``).
                offset = len(line.text) - len(rest)
                self.lines[i] = _Line(indent + offset, rest, line.number)
                value, i = self.block(i, indent + offset)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].number, 'unexpected indentation')
        return out, i

    def key_split(self, line: _Line):
        """(key, rest of the line) if the line is ``key: ...``."""
        text = line.text
        if text[0] in '\'"':
            key, end = self.quoted(text, 0, line.number)
            rest = text[end:].lstrip(' ')
            if not rest.startswith(':') or rest[1:2] not in ('', ' '):
                return None
            return key, rest[1:].strip()
        if text[0] in '[{?&*!|>%@`':
            if text[0] in '?&*!|>%@`':
                self.fail(line.number, f'{text[0]!r} (complex keys, '
                          'anchors, aliases, tags, block scalars) is '
                          'outside this reader\'s subset')
            return None
        m = re.search(r':(?: |$)', text)
        if m is None:
            return None
        key = text[:m.start()].rstrip()
        return resolve_plain(key, f'{self.source}:{line.number}'), \
            text[m.end():].strip()

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            split = self.key_split(line)
            if split is None:
                self.fail(line.number, 'expected "key: value"')
            key, rest = split
            if isinstance(key, (list, dict)):
                self.fail(line.number, 'a collection as a key')
            if rest:
                value = self.inline(rest, line.number)
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    self.fail(self.lines[i].number, 'a multi-line scalar '
                              'is outside this reader\'s subset')
            else:
                value, i = self.nested(i + 1, indent, True)
            out[key] = value
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].number, 'unexpected indentation')
        return out, i

    # ------------------------------------------------------------ scalars
    def inline(self, text: str, number: int) -> Any:
        """A value that fits on its line: a flow collection, a quoted
        scalar or a plain scalar."""
        first = text[0]
        if first in '[{':
            value, end = self.flow(text, 0, number)
            if text[end:].strip():
                self.fail(number, f'text after a flow collection: '
                          f'{text[end:]!r}')
            return value
        if first in '\'"':
            value, end = self.quoted(text, 0, number)
            if text[end:].strip():
                self.fail(number, f'text after a quoted scalar: '
                          f'{text[end:]!r}')
            return value
        if first in '&*!|>%@`?':
            self.fail(number, f'{first!r} (anchors, aliases, tags, block '
                      'scalars) is outside this reader\'s subset')
        if self.is_item(text) or re.search(r':(?: |$)', text):
            self.fail(number, 'a block collection on a key\'s line')
        return resolve_plain(text, f'{self.source}:{number}')

    def quoted(self, text: str, start: int, number: int) -> Tuple[str, int]:
        """The quoted scalar at ``start``: (value, index after it)."""
        q = text[start]
        out = []
        i = start + 1
        while i < len(text):
            ch = text[i]
            if ch == q:
                if q == "'" and text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return ''.join(out), i + 1
            if q == '"' and ch == '\\':
                esc = text[i + 1:i + 2]
                if esc in _DOUBLE_ESCAPES:
                    out.append(_DOUBLE_ESCAPES[esc])
                    i += 2
                elif esc in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[esc]
                    code = text[i + 2:i + 2 + width]
                    if not re.fullmatch(r'[0-9A-Fa-f]{%d}' % width, code):
                        self.fail(number, f'bad escape \\{esc}{code}')
                    out.append(chr(int(code, 16)))
                    i += 2 + width
                else:
                    self.fail(number, f'bad escape \\{esc}')
                continue
            out.append(ch)
            i += 1
        self.fail(number, 'a quoted scalar that does not end on its line '
                  '(multi-line scalars are outside this reader\'s subset)')

    def flow(self, text: str, start: int, number: int) -> Tuple[Any, int]:
        """The flow sequence or mapping at ``start``: (value, index after
        its closing bracket)."""
        close = ']' if text[start] == '[' else '}'
        is_map = close == '}'
        out: Any = {} if is_map else []
        i = start + 1
        while True:
            while i < len(text) and text[i] == ' ':
                i += 1
            if i >= len(text):
                self.fail(number, 'a flow collection that does not end on '
                          'its line')
            if text[i] == close:
                return out, i + 1
            key, i = self.flow_node(text, i, number, is_map)
            while i < len(text) and text[i] == ' ':
                i += 1
            if is_map:
                if text[i:i + 1] != ':':
                    self.fail(number, 'expected ":" in a flow mapping')
                value, i = self.flow_node(text, i + 1, number, True)
                out[key] = value
            else:
                out.append(key)
            while i < len(text) and text[i] == ' ':
                i += 1
            if text[i:i + 1] == ',':
                i += 1
            elif text[i:i + 1] != close:
                self.fail(number, f'expected "," or {close!r} in a flow '
                          'collection')

    def flow_node(self, text: str, i: int, number: int,
                  in_map: bool) -> Tuple[Any, int]:
        while i < len(text) and text[i] == ' ':
            i += 1
        if i >= len(text):
            self.fail(number, 'a flow collection that does not end on its '
                      'line')
        ch = text[i]
        if ch in '[{':
            return self.flow(text, i, number)
        if ch in '\'"':
            return self.quoted(text, i, number)
        if ch in '&*!|>%@`?':
            self.fail(number, f'{ch!r} (anchors, aliases, tags) is outside '
                      'this reader\'s subset')
        stop = ',]}' + (':' if in_map else '')
        j = i
        while j < len(text) and text[j] not in stop:
            j += 1
        if not text[i:j].strip():
            self.fail(number, 'an empty entry in a flow collection')
        return resolve_plain(text[i:j].strip(),
                             f'{self.source}:{number}'), j


def load(text: str, source: str = '<yaml>') -> Any:
    """``text`` read as ``yaml.safe_load`` reads it, within the subset the
    module docstring names; ValueError naming the line otherwise."""
    return _Reader(text, source).document()


def load_file(path: Union[str, Path]) -> Any:
    with open(path, 'r', encoding='utf-8') as f:
        return load(f.read(), str(path))


# ------------------------------------------------------------------ writer
def _plain_ok(s: str) -> bool:
    """Whether a string can be written plain and read back as itself."""
    return (s != '' and s == s.strip() and s[0] not in _INDICATORS
            and ': ' not in s and ' #' not in s and not s.endswith(':')
            and s.isprintable() and _resolve_kind(s) == 'str')


def _scalar(value: Any) -> str:
    if hasattr(value, 'item') and type(value).__module__ == 'numpy':
        value = value.item()
    if value is None:
        return 'null'
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return '.nan'
        if value in (math.inf, -math.inf):
            return '.inf' if value > 0 else '-.inf'
        text = repr(value).lower()
        if '.' not in text and 'e' in text:
            text = text.replace('e', '.0e', 1)
        return text
    if isinstance(value, str):
        if _plain_ok(value):
            return value
        if value.isprintable():
            return "'" + value.replace("'", "''") + "'"
        return json.dumps(value, ensure_ascii=False)
    raise TypeError(f'cannot write a {type(value).__name__} as YAML')


def _emit(value: Any, indent: int, out: List[str]):
    pad = ' ' * indent
    if isinstance(value, dict):
        for key, v in value.items():
            head = f'{pad}{_scalar(key)}:'
            if isinstance(v, dict) and v:
                out.append(head)
                _emit(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(head)
                _emit(v, indent, out)
            else:
                out.append(f'{head} {_inline(v)}')
        return
    for v in value:
        if isinstance(v, (dict, list, tuple)) and v:
            sub: List[str] = []
            _emit(v, indent + 2, sub)
            out.append(f'{pad}- {sub[0][indent + 2:]}')
            out.extend(sub[1:])
        else:
            out.append(f'{pad}- {_inline(v)}')


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return '{}'
    if isinstance(value, (list, tuple)):
        return '[]'
    return _scalar(value)


def dump(value: Any) -> str:
    """``value`` (mappings, lists, tuples and scalars) as block YAML."""
    if isinstance(value, (dict, list, tuple)) and value:
        out: List[str] = []
        _emit(value, 0, out)
        return '\n'.join(out) + '\n'
    return _inline(value) + '\n'


def dump_file(value: Any, path: Union[str, Path]):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w', encoding='utf-8') as f:
        f.write(dump(value))
