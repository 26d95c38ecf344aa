"""The YAML that ASDF trees use, read and written without PyYAML.

The JAX package parses an ASDF tree with ``yaml.SafeLoader`` plus a tag
constructor (abacusutils_tpu/io/asdf_file.py:_make_loader) and writes it
with ``yaml.dump``. The machine with the card has no ``yaml``, so this
module reads and writes the subset of YAML 1.1 that those trees hold:

- the ``%YAML`` and ``%TAG`` directives, ``---`` and ``...``, comments;
- block mappings and block sequences (indentless ones included), flow
  sequences and flow mappings, over several lines too;
- plain, single-quoted and double-quoted scalars, folded over lines, with
  PyYAML's YAML 1.1 resolution of plain scalars: int (with ``0x``, ``0b``,
  octal and sexagesimal forms), float (``.inf`` and ``.nan`` included),
  bool, null, else str;
- local tags (``!core/ndarray-1.0.0``, through the document's ``%TAG``),
  verbatim tags (``!<tag:astropy.org:...>``) and the standard ``!!`` tags
  (``!!str``, ``!!int``, ``!!float``, ``!!bool``, ``!!null``, ``!!map``,
  ``!!seq``, ``!!omap``); anchors and aliases;
- keys with spaces and parentheses (``k (h/Mpc)``).

:func:`load` constructs what the JAX package's loader constructs: an ASDF
or astropy tag (or a ``!`` tag that no ``%TAG`` expands) becomes
:class:`Tagged` (its suffix, and the mapping, list or unresolved string
beneath it), ``!!omap`` a list of (key, value) tuples. Anything outside the
subset (block scalars ``|`` and ``>``, complex keys ``?``, merge keys,
timestamps, other tags) raises ``ValueError`` with its line number.
:func:`dump` writes a tree of dicts, lists, scalars and :class:`Tagged`
nodes in the same subset.
"""

import math
import re

import numpy as np

__all__ = ['Tagged', 'load', 'dump', 'ASDF_TAG', 'ASTROPY_TAG']

ASDF_TAG = 'tag:stsci.edu:asdf/'
ASTROPY_TAG = 'tag:astropy.org:astropy/'
_YAML_TAG = 'tag:yaml.org,2002:'


class Tagged:
    """A node under an application tag (the JAX package's ``_Tagged``):
    ``tag`` is the suffix after the tag prefix on read, the full tag or
    ``!``-local form on write."""

    __slots__ = ('tag', 'value')

    def __init__(self, tag, value):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f'Tagged({self.tag!r}, {self.value!r})'


# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order
_BOOL = re.compile(r'yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF')
_FLOAT = re.compile(r'''[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                       |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                       |[-+]?\.(?:inf|Inf|INF)
                       |\.(?:nan|NaN|NAN)''', re.X)
_INT = re.compile(r'''[-+]?0b[0-1_]+
                     |[-+]?0[0-7_]+
                     |[-+]?(?:0|[1-9][0-9_]*)
                     |[-+]?0x[0-9a-fA-F_]+
                     |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+''', re.X)
_NULL = re.compile(r'~|null|Null|NULL|')
_TIMESTAMP = re.compile(r'''[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                           |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                            (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                            (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?''', re.X)


def _resolve(value):
    """The YAML 1.1 type of a plain scalar: 'bool', 'float', 'int', 'null',
    'timestamp', 'merge', 'value' or 'str'."""
    first = value[:1]
    if first in 'yYnNtTfFoO' and first and _BOOL.fullmatch(value):
        return 'bool'
    if first and first in '-+0123456789.' and _FLOAT.fullmatch(value):
        return 'float'
    if first and first in '-+0123456789' and _INT.fullmatch(value):
        return 'int'
    if value == '<<':
        return 'merge'
    if first in ('~', 'n', 'N', '') and _NULL.fullmatch(value):
        return 'null'
    if first and first in '0123456789' and _TIMESTAMP.fullmatch(value):
        return 'timestamp'
    if value == '=':
        return 'value'
    return 'str'


def _sexagesimal(value, cast):
    out, base = 0, 1
    for part in reversed(value.split(':')):
        out += cast(part) * base
        base *= 60
    return out


def _to_int(value):
    value = value.replace('_', '')
    sign = -1 if value[0] == '-' else 1
    if value[0] in '+-':
        value = value[1:]
    if value == '0':
        return 0
    if value.startswith('0b'):
        return sign * int(value[2:], 2)
    if value.startswith('0x'):
        return sign * int(value[2:], 16)
    if value[0] == '0':
        return sign * int(value, 8)
    if ':' in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value):
    value = value.replace('_', '').lower()
    sign = -1 if value[0] == '-' else 1
    if value[0] in '+-':
        value = value[1:]
    if value == '.inf':
        return sign * math.inf
    if value == '.nan':
        return math.nan
    if ':' in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


_SCALARS = {
    'bool': lambda v: v.lower() in ('yes', 'true', 'on'),
    'float': _to_float,
    'int': _to_int,
    'null': lambda v: None,
    'str': lambda v: v,
}

_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t', 'n': '\n', 'v': '\v',
            'f': '\f', 'r': '\r', 'e': '\x1b', ' ': ' ', '"': '"', '/': '/', '\\': '\\',
            'N': '\x85', '_': '\xa0', 'L': '\u2028', 'P': '\u2029'}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}


class _Parser:
    """A recursive-descent reader of one YAML document into nodes:
    ('scalar', tag, text, style, line), ('seq', tag, [nodes], None, line) or
    ('map', tag, [(key, value)], None, line)."""

    def __init__(self, text):
        self.s = text.replace('\r\n', '\n')
        self.n = len(self.s)
        odd = re.search('[\r\x85\u2028\u2029]', self.s)
        if odd:
            self.error(f'the line break {odd.group()!r} is outside the subset', odd.start())
        self.pos = 0
        self.handles = {'!': '!', '!!': _YAML_TAG}
        self.anchors = {}

    # -- positions ---------------------------------------------------------
    def line(self, pos=None):
        return self.s.count('\n', 0, self.pos if pos is None else pos) + 1

    def error(self, msg, pos=None):
        raise ValueError(f'YAML line {self.line(pos)}: {msg}')

    def col(self):
        return self.pos - (self.s.rfind('\n', 0, self.pos) + 1)

    def peek(self, k=0):
        i = self.pos + k
        return self.s[i] if i < self.n else ''

    def skip_inline(self):
        """Spaces and a comment up to the end of the line."""
        s = self.s
        while self.pos < self.n and s[self.pos] in ' \t':
            self.pos += 1
        if self.peek() == '#' and (self.pos == 0 or s[self.pos - 1] in ' \t\n'):
            j = s.find('\n', self.pos)
            self.pos = self.n if j < 0 else j

    def skip_blank(self):
        """Whitespace, line breaks and comments."""
        while True:
            self.skip_inline()
            if self.peek() == '\n':
                self.pos += 1
                continue
            return

    def at_line_end(self):
        return self.pos >= self.n or self.s[self.pos] == '\n'

    def at_doc_marker(self):
        return (self.col() == 0 and self.s.startswith(('---', '...'), self.pos)
                and self.peek(3) in ('', ' ', '\t', '\n'))

    def at_seq_entry(self):
        return self.peek() == '-' and self.peek(1) in ('', ' ', '\n')

    # -- document ----------------------------------------------------------
    def document(self):
        while True:
            self.skip_blank()
            if self.pos >= self.n:
                self.error('no document')
            if self.peek() != '%' or self.col() != 0:
                break
            end = self.s.find('\n', self.pos)
            end = self.n if end < 0 else end
            parts = self.s[self.pos : end].split()
            if parts[0] == '%TAG' and len(parts) == 3:
                self.handles[parts[1]] = parts[2]
            elif parts[0] != '%YAML':
                self.error(f'directive {parts[0]} is outside the subset')
            self.pos = end
        if self.at_doc_marker() and self.s.startswith('---', self.pos):
            self.pos += 3
        node = self.block_node(-1, False)
        self.skip_blank()
        if self.pos < self.n:
            if not (self.at_doc_marker() and self.s.startswith('...', self.pos)):
                self.error('content after the document')
            self.pos += 3
            self.skip_blank()
            if self.pos < self.n:
                self.error('a second document is outside the subset')
        return node

    # -- node properties ---------------------------------------------------
    def tag(self):
        s, start = self.s, self.pos
        if s.startswith('!<', start):
            end = s.find('>', start)
            if end < 0:
                self.error('unterminated verbatim tag')
            self.pos = end + 1
            return s[start + 2 : end]
        end = start + 1
        while end < self.n and s[end] not in ' \t\n,[]{}':
            end += 1
        text = s[start:end]
        self.pos = end
        if text == '!':
            return '!'
        second = text.find('!', 1)
        handle, suffix = (text[: second + 1], text[second + 1 :]) if second > 0 else ('!', text[1:])
        if handle not in self.handles:
            self.error(f'undeclared tag handle {handle}')
        return self.handles[handle] + suffix

    def props(self, flow=False):
        tag = anchor = None
        while True:
            c = self.peek()
            if c == '!' and tag is None:
                tag = self.tag()
            elif c == '&' and anchor is None:
                end = self.pos + 1
                while end < self.n and self.s[end] not in ' \t\n,[]{}':
                    end += 1
                anchor, self.pos = self.s[self.pos + 1 : end], end
            else:
                return tag, anchor
            if flow:
                self.skip_blank()
            else:
                self.skip_inline()

    def alias(self):
        end = self.pos + 1
        while end < self.n and self.s[end] not in ' \t\n,[]{}':
            end += 1
        name, self.pos = self.s[self.pos + 1 : end], end
        if name not in self.anchors:
            self.error(f'undefined alias *{name}')
        return self.anchors[name]

    def finish(self, node, tag, anchor):
        if tag is not None:
            node = (node[0], tag) + node[2:]
        if anchor is not None:
            self.anchors[anchor] = node
        return node

    # -- block structure ---------------------------------------------------
    def is_key(self):
        """Whether a simple key followed by ':' starts here (this line only)."""
        s, p = self.s, self.pos
        c = self.peek()
        if c in ('', '\n', '[', '{', '|', '>', '#') or self.at_seq_entry():
            return False
        if c == '?' and self.peek(1) in ('', ' ', '\n'):
            self.error('complex keys are outside the subset')
        eol = s.find('\n', p)
        eol = self.n if eol < 0 else eol
        if c in '\'"':
            save = self.pos
            try:
                self.quoted(self.pos)
            finally:
                end, self.pos = self.pos, save
            if self.line(end) != self.line(p):
                return False
            rest = s[end:eol].lstrip(' \t')
            return rest.startswith(':') and rest[1:2] in ('', ' ', '\t')
        j = p
        while j < eol:
            if s[j] == ':' and (j + 1 == eol or s[j + 1] in ' \t'):
                return True
            if s[j] == '#' and s[j - 1] in ' \t':
                return False
            j += 1
        return False

    def block_node(self, indent, seq_here):
        """The node that follows ':', '- ' or '---' (pos just after it): its
        content on this line, or on the lines below indented past `indent`
        (at `indent` too for a sequence under a mapping key, `seq_here`)."""
        self.skip_inline()
        line = self.line()
        tag, anchor = self.props()
        if self.peek() == '*':
            if tag or anchor:
                self.error('properties on an alias')
            return self.alias()
        if self.at_line_end():
            self.skip_blank()
            c = self.col()
            inside = self.pos < self.n and not self.at_doc_marker() and (
                c > indent or (c == indent and seq_here and self.at_seq_entry()))
            if not inside:
                return self.finish(('scalar', None, '', 'plain', line), tag, anchor)
            if tag is None and anchor is None:
                tag, anchor = self.props()
                if self.at_line_end():
                    self.skip_blank()
                    if self.col() <= indent:
                        return self.finish(('scalar', None, '', 'plain', line), tag, anchor)
            c = self.col()
            if self.at_seq_entry():
                node = self.block_seq(c)
            elif self.is_key():
                node = self.block_map(c)
            else:
                node = self.inline_node(indent)
        elif self.at_seq_entry():
            node = self.block_seq(self.col())
        elif self.is_key():
            node = self.block_map(self.col())
        else:
            node = self.inline_node(indent)
        return self.finish(node, tag, anchor)

    def block_seq(self, col):
        line, items = self.line(), []
        while True:
            self.pos += 1  # the '-'
            items.append(self.block_node(col, False))
            self.skip_blank()
            if self.pos >= self.n or self.at_doc_marker():
                break
            c = self.col()
            if c > col:
                self.error('bad indentation of a sequence entry')
            if c < col or not self.at_seq_entry():
                break
        return ('seq', None, items, None, line)

    def block_map(self, col):
        line, pairs = self.line(), []
        while True:
            key = self.key_node()
            self.skip_inline()
            if self.peek() != ':':
                self.error('expected ":" after a mapping key')
            self.pos += 1
            pairs.append((key, self.block_node(col, True)))
            self.skip_blank()
            if self.pos >= self.n or self.at_doc_marker():
                break
            c = self.col()
            if c < col:
                break
            if c > col:
                self.error('bad indentation of a mapping entry')
            if not self.is_key():
                if self.at_seq_entry():
                    break
                self.error('expected a mapping key')
        return ('map', None, pairs, None, line)

    def key_node(self):
        line = self.line()
        tag, anchor = self.props()
        c = self.peek()
        if c == '*':
            return self.alias()
        if c in '\'"':
            node = ('scalar', None, self.quoted(self.pos), 'quoted', line)
        else:
            start, s = self.pos, self.s
            while not (s[self.pos] == ':' and self.peek(1) in ('', ' ', '\t', '\n')):
                self.pos += 1
            node = ('scalar', None, s[start : self.pos].rstrip(' \t'), 'plain', line)
        return self.finish(node, tag, anchor)

    # -- scalars and flow collections --------------------------------------
    def inline_node(self, indent):
        c = self.peek()
        line = self.line()
        if c in '[{':
            return self.flow_collection()
        if c in '\'"':
            return ('scalar', None, self.quoted(self.pos), 'quoted', line)
        if c in '|>':
            self.error('block scalars (| and >) are outside the subset')
        if c in '%@`':
            self.error(f'a plain scalar may not start with {c!r}')
        return ('scalar', None, self.plain(indent, False), 'plain', line)

    def plain(self, indent, flow):
        """A plain scalar from pos: runs of text folded over lines indented
        past `indent` (any indentation inside a flow collection)."""
        s, out = self.s, []
        breaks = 0
        while True:
            start = j = self.pos
            while j < self.n:
                c = s[j]
                if c == '\n':
                    break
                if c == ':' and (j + 1 == self.n or s[j + 1] in ' \t\n'
                                 or (flow and s[j + 1] in ',[]{}')):
                    break
                if flow and c in ',[]{}':
                    break
                if c == '#' and j > start and s[j - 1] in ' \t':
                    break
                j += 1
            text = s[start:j].rstrip(' \t')
            if text:
                if out:
                    out.append(' ' if breaks == 1 else '\n' * (breaks - 1))
                out.append(text)
            self.pos = start + len(text)
            if j >= self.n or s[j] != '\n' or not text:
                return ''.join(out)
            # a continuation line: past `indent`, not a comment or marker
            k, breaks = j, 0
            while k < self.n and s[k] == '\n':
                breaks += 1
                k += 1
                while k < self.n and s[k] in ' \t':
                    k += 1
            save = self.pos
            self.pos = k
            cont = (k < self.n and s[k] != '#' and not self.at_doc_marker()
                    and (flow or self.col() > indent)
                    and not (flow and s[k] in ',[]{}:'))
            if not cont:
                self.pos = save
                return ''.join(out)

    def quoted(self, pos):
        """A single- or double-quoted scalar at pos; leaves pos after it."""
        s, q = self.s, self.s[pos]
        out, i = [], pos + 1
        while True:
            if i >= self.n:
                self.error('unterminated quoted scalar', pos)
            c = s[i]
            if c == q:
                if q == "'" and s[i + 1 : i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return ''.join(out)
            if q == '"' and c == '\\':
                e = s[i + 1 : i + 2]
                if e == '\n':  # an escaped line break joins the lines
                    i += 2
                    while i < self.n and s[i] in ' \t':
                        i += 1
                    continue
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX_ESCAPES:
                    w = _HEX_ESCAPES[e]
                    out.append(chr(int(s[i + 2 : i + 2 + w], 16)))
                    i += 2 + w
                    continue
                self.error(f'unknown escape \\{e}', i)
            if c in ' \t\n':
                # whitespace: kept inside a line; a line break folds
                j = i
                while j < self.n and s[j] in ' \t':
                    j += 1
                if j < self.n and s[j] == '\n':
                    breaks = 0
                    while j < self.n and s[j] in ' \t\n':
                        breaks += s[j] == '\n'
                        j += 1
                    out.append(' ' if breaks == 1 else '\n' * (breaks - 1))
                    i = j
                    continue
                out.append(s[i:j])
                i = j
                continue
            out.append(c)
            i += 1

    def flow_node(self):
        self.skip_blank()
        line = self.line()
        tag, anchor = self.props(flow=True)
        c = self.peek()
        if c == '*':
            return self.alias()
        if c in '[{':
            node = self.flow_collection()
        elif c in '\'"':
            node = ('scalar', None, self.quoted(self.pos), 'quoted', line)
        elif c in ',]}':
            node = ('scalar', None, '', 'plain', line)
        else:
            node = ('scalar', None, self.plain(-1, True), 'plain', line)
        return self.finish(node, tag, anchor)

    def flow_collection(self):
        line, opener = self.line(), self.peek()
        closer = ']' if opener == '[' else '}'
        self.pos += 1
        items = []
        while True:
            self.skip_blank()
            if self.peek() == closer:
                self.pos += 1
                break
            if self.peek() == '?':
                self.error('complex keys are outside the subset')
            key = self.flow_node()
            self.skip_blank()
            if self.peek() == ':':
                if opener == '[':
                    self.error('a mapping inside a flow sequence is outside the subset')
                self.pos += 1
                self.skip_blank()
                if self.peek() in (',', '}'):
                    value = ('scalar', None, '', 'plain', self.line())
                else:
                    value = self.flow_node()
                items.append((key, value))
            else:
                items.append(key if opener == '[' else (key, ('scalar', None, '', 'plain', line)))
            self.skip_blank()
            c = self.peek()
            if c == ',':
                self.pos += 1
            elif c != closer:
                self.error(f'expected "," or "{closer}" in a flow collection')
        return ('seq' if opener == '[' else 'map', None, items, None, line)


def _construct(node):
    """Python values from a node, as the JAX package's SafeLoader with its
    tag constructor builds them."""
    kind, tag, value, style, line = node

    def fail(msg):
        raise ValueError(f'YAML line {line}: {msg}')

    if tag is not None and tag != '!' and not tag.startswith(_YAML_TAG):
        for prefix in (ASDF_TAG, ASTROPY_TAG, '!'):
            if tag.startswith(prefix):
                if kind == 'map':
                    inner = _mapping(value, fail)
                elif kind == 'seq':
                    inner = [_construct(v) for v in value]
                else:
                    inner = value
                return Tagged(tag[len(prefix):], inner)
        fail(f'tag {tag} is outside the subset')
    name = None if tag is None or tag == '!' else tag[len(_YAML_TAG):]
    if kind == 'scalar':
        if name is None:
            name = _resolve(value) if (style == 'plain' and tag is None) else 'str'
        if name not in _SCALARS:
            fail(f'a {name} scalar ({value!r}) is outside the subset')
        try:
            return _SCALARS[name](value)
        except (ValueError, IndexError):
            fail(f'{value!r} is not a valid {name}')
    if kind == 'seq' and name in (None, 'seq'):
        return [_construct(v) for v in value]
    if kind == 'map' and name in (None, 'map'):
        return _mapping(value, fail)
    if kind == 'seq' and name == 'omap':
        out = []
        for sub in value:
            if sub[0] != 'map' or len(sub[2]) != 1:
                fail('an !!omap entry must be a mapping of one pair')
            k, v = sub[2][0]
            out.append((_construct(k), _construct(v)))
        return out
    fail(f'a {kind} tagged {tag} is outside the subset')


def _mapping(pairs, fail):
    out = {}
    for k, v in pairs:
        if k[0] == 'scalar' and k[1] is None and k[3] == 'plain' and k[2] == '<<':
            fail('merge keys are outside the subset')
        key = _construct(k)
        if isinstance(key, (list, dict, Tagged)):
            fail('a collection as a mapping key is outside the subset')
        out[key] = _construct(v)
    return out


def load(text):
    """The tree of one YAML document (the subset in the module docstring)."""
    return _construct(_Parser(text).document())


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_INDICATORS = set('-?:,[]{}#&*!|>\'"%@`')


def _printable(ch):
    o = ord(ch)
    return (0x20 <= o <= 0x7E or 0xA0 <= o <= 0xD7FF or 0xE000 <= o <= 0xFFFD
            or 0x10000 <= o <= 0x10FFFF) and ch not in '\x85\u2028\u2029'


def _str(s):
    """A string as a plain, single-quoted or double-quoted scalar that reads
    back as that string in block and in flow context."""
    if (s and s == s.strip() and s[0] not in _INDICATORS and all(map(_printable, s))
            and not any(c in s for c in ',?[]{}') and ': ' not in s and ' #' not in s
            and not s.endswith(':') and _resolve(s) == 'str'
            and not s.startswith(('---', '...'))):
        return s
    if all(map(_printable, s)):
        return "'" + s.replace("'", "''") + "'"
    out = []
    for ch in s:
        if ch in '"\\':
            out.append('\\' + ch)
        elif _printable(ch):
            out.append(ch)
        elif ord(ch) <= 0xFF:
            out.append(f'\\x{ord(ch):02x}')
        elif ord(ch) <= 0xFFFF:
            out.append(f'\\u{ord(ch):04x}')
        else:
            out.append(f'\\U{ord(ch):08x}')
    return '"' + ''.join(out) + '"'


def _float(v):
    if v != v:
        return '.nan'
    if v in (math.inf, -math.inf):
        return '.inf' if v > 0 else '-.inf'
    text = repr(float(v)).lower()
    if '.' not in text and 'e' in text:
        text = text.replace('e', '.0e', 1)
    if '.' not in text:
        text += '.0'
    return text


def _scalar(v):
    if v is None:
        return 'null'
    if isinstance(v, (bool, np.bool_)):
        return 'true' if v else 'false'
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return _float(float(v))
    if isinstance(v, str):
        return _str(v)
    raise TypeError(f'cannot write {type(v).__name__} into an ASDF tree')


def _tag_text(tag):
    if tag.startswith(ASDF_TAG):
        return '!' + tag[len(ASDF_TAG):]
    if tag.startswith(_YAML_TAG):
        return '!!' + tag[len(_YAML_TAG):]
    return f'!<{tag}>'


def _is_collection(v):
    return isinstance(v, (dict, list, tuple, Tagged))


def _flow(v):
    """The flow text of a scalar or of a (nested) list of scalars, else None."""
    if isinstance(v, (list, tuple)):
        parts = [_flow(x) for x in v]
        return None if None in parts else '[' + ', '.join(parts) + ']'
    if isinstance(v, dict):
        return '{}' if not v else None
    if isinstance(v, Tagged):
        return None
    return _scalar(v)


def _entry(head, v, indent, lines):
    """`head` ('key:' or '-') followed by node v, its block lines indented by
    `indent`."""
    tag = ''
    if isinstance(v, Tagged):
        tag, v = ' ' + _tag_text(v.tag), v.value
    flow = _flow(v)
    if flow is not None:
        lines.append(f'{head}{tag} {flow}')
    elif isinstance(v, dict):
        lines.append(head + tag)
        _map_lines(v, indent, lines)
    else:
        lines.append(head + tag)
        _seq_lines(v, indent, lines)


def _map_lines(d, indent, lines):
    pad = ' ' * indent
    for k, v in d.items():
        if not isinstance(k, (str, int, np.integer)) or isinstance(k, bool):
            raise TypeError(f'cannot write a {type(k).__name__} mapping key into an ASDF tree')
        _entry(f'{pad}{_scalar(k)}:', v, indent + 2, lines)


def _seq_lines(items, indent, lines):
    pad = ' ' * indent
    for v in items:
        _entry(f'{pad}-', v, indent + 2, lines)


def dump(tree):
    """The block YAML (lines joined, with a final newline) of a mapping of
    dicts, lists, scalars (numpy's included) and :class:`Tagged` nodes, whose
    tags are full tag names."""
    lines = []
    _map_lines(tree, 0, lines)
    return '\n'.join(lines) + '\n'
