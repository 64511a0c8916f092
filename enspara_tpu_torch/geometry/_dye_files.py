"""Readers of the dye library's two text formats without pyyaml or pandas:
``libraries.yml`` (the subset of YAML the library uses) and the ``R0/``
spectra and photophysics CSVs (pandas' reading of them, where it decides
the numbers).

``load_library_yaml`` reads a top-level map of dye names (keys may hold
spaces), each a map of keys to strings, to block lists of strings (``- C``,
``- name C``) or to the empty flow list ``[]``. Anything else raises
``DataInvalid`` naming the line: a scalar that YAML would read as a number,
a boolean, a date or null, a nested map, a flow collection other than
``[]``, an anchor, a tag, a block scalar, a duplicate key.

``read_csv`` reads a comma-separated table into ``{column: array}``: a
column whose cells all read as integers is int64, as decimals float64,
else strings (object); an empty cell is NaN (and makes an integer column
float64), as pandas' ``read_csv`` has them.
"""

import csv
import re

import numpy as np

from ..exception import DataInvalid

__all__ = ['load_library_yaml', 'read_csv']

# the plain scalars YAML 1.1 resolves to another type than a string
# (pyyaml's implicit resolvers: bool, float, int, merge, null, timestamp,
# value)
_NOT_STRING = re.compile(r'''^(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE
    |on|On|ON|off|Off|OFF
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN)
    |[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |<<|~|null|Null|NULL|=
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[\ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?
    )$''', re.X)

# characters that open something other than a plain or quoted scalar
_INDICATORS = set('[]{}&*!|>%@`,?-')


def _bad(path, lineno, why):
    return DataInvalid('%s, line %d: %s (outside the subset of YAML the dye '
                       'library uses)' % (path, lineno, why))


def _scalar(text, path, lineno):
    """The string of one YAML scalar (plain, 'single' or "double" quoted,
    a trailing comment allowed), or raise."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        q = text[0]
        out, i = [], 1
        while True:
            j = text.find(q, i)
            if j < 0:
                raise _bad(path, lineno, 'unterminated quoted scalar')
            out.append(text[i:j])
            if q == "'" and text[j + 1:j + 2] == "'":
                out.append("'")
                i = j + 2
                continue
            break
        rest = text[j + 1:].strip()
        if rest and not rest.startswith('#'):
            raise _bad(path, lineno, 'text after a quoted scalar')
        value = ''.join(out)
        if q == '"' and '\\' in value:
            raise _bad(path, lineno, 'an escape in a double-quoted scalar')
        return value
    cut = re.search(r'\s#', text)
    if cut:
        text = text[:cut.start()].rstrip()
    if not text:
        raise _bad(path, lineno, 'an empty (null) value')
    if text[0] in _INDICATORS and not (text[0] == '-' and text[1:2]
                                       not in ('', ' ')):
        raise _bad(path, lineno, '%r opens no plain scalar' % text)
    if ': ' in text or text.endswith(':'):
        raise _bad(path, lineno, 'a map inside a value: %r' % text)
    if _NOT_STRING.match(text):
        raise _bad(path, lineno, '%r is not a string in YAML' % text)
    return text


def _key_value(body, path, lineno):
    """(key, value text or None) of a ``key: value`` or ``key:`` line."""
    if body[:1] in ("'", '"'):
        end = body.find(body[0], 1)
        while body[0] == "'" and body[end + 1:end + 2] == "'":
            end = body.find("'", end + 2)
        if end < 0 or body[end + 1:end + 2] != ':':
            raise _bad(path, lineno, 'a quoted key without its colon')
        key, rest = _scalar(body[:end + 1], path, lineno), body[end + 2:]
    else:
        m = re.search(r':(\s|$)', body)
        if m is None:
            raise _bad(path, lineno, 'a line that is no "key: value"')
        key, rest = _scalar(body[:m.start()], path, lineno), body[m.end():]
    rest = rest.strip()
    if not rest or rest.startswith('#'):
        return key, None
    return key, rest


def load_library_yaml(path):
    """``libraries.yml`` as ``yaml.safe_load`` reads it, for the subset of
    YAML this module's docstring names; anything else raises
    ``DataInvalid`` naming the line."""
    with open(path) as f:
        lines = f.read().splitlines()
    lib = {}
    entry = None            # the current dye's map
    pending = None          # (key, indent, lineno) of a 'key:' line
    inner = None            # the indent of the current dye's keys
    seen_content = False

    def close_pending():
        if pending is not None and not isinstance(entry[pending[0]], list):
            raise _bad(path, pending[2], 'an empty (null) value')

    for lineno, line in enumerate(lines, 1):
        body = line.lstrip(' ')
        if not body.strip() or body.startswith('#'):
            continue
        if body.startswith('\t') or '\t' in line[:len(line) - len(body)]:
            raise _bad(path, lineno, 'a tab in the indentation')
        indent = len(line) - len(body)
        body = body.rstrip()
        if body == '---' and indent == 0 and not seen_content:
            seen_content = True
            continue
        seen_content = True
        if indent == 0:
            if body.startswith('- '):
                raise _bad(path, lineno, 'a list at the top level')
            close_pending()
            pending = None
            name, rest = _key_value(body, path, lineno)
            if rest is not None:
                raise _bad(path, lineno, 'a dye name mapped to a scalar')
            if name in lib:
                raise _bad(path, lineno, 'dye %r named twice' % name)
            entry = lib[name] = {}
            inner = None
            continue
        if entry is None:
            raise _bad(path, lineno, 'an indented line before a dye name')
        if body == '-' or body.startswith('- '):
            if pending is None or indent < pending[1]:
                raise _bad(path, lineno, 'a list item under no list key')
            item = body[1:].strip()
            if item[:1] in ('[', '{') or item.startswith('- '):
                raise _bad(path, lineno, 'a nested collection')
            if not item:
                raise _bad(path, lineno, 'an empty (null) list item')
            if not isinstance(entry[pending[0]], list):
                entry[pending[0]] = []
            entry[pending[0]].append(_scalar(item, path, lineno))
            continue
        if inner is None:
            inner = indent
        if indent != inner:
            raise _bad(path, lineno, 'indentation %d where the keys of this '
                                     'dye sit at %d' % (indent, inner))
        close_pending()
        pending = None
        key, rest = _key_value(body, path, lineno)
        if key in entry:
            raise _bad(path, lineno, 'key %r named twice' % key)
        if rest is None:
            entry[key] = None
            pending = (key, indent, lineno)
        elif re.fullmatch(r'\[\s*\](\s+#.*)?', rest):
            entry[key] = []
        else:
            entry[key] = _scalar(rest, path, lineno)
    close_pending()
    return lib


_INT = re.compile(r'^\s*[-+]?[0-9]+\s*$')
_FLOAT = re.compile(
    r'^\s*[-+]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][-+]?[0-9]+)?\s*$')


def _column(cells):
    filled = [c for c in cells if c.strip()]
    empty = len(filled) < len(cells)
    if filled and all(_INT.match(c) for c in filled) and not empty:
        return np.array([int(c) for c in cells], dtype=np.int64)
    if all(_FLOAT.match(c) for c in filled):
        return np.array([float(c) if c.strip() else np.nan for c in cells],
                        dtype=np.float64)
    return np.array([c if c.strip() else np.nan for c in cells],
                    dtype=object)


def read_csv(path, names=None):
    """A comma-separated table as ``{column: array}``, typed as this
    module's docstring says. The first line names the columns, unless
    ``names`` does (then every line is data). Blank lines are skipped; a
    short row's missing cells are empty; a long row raises
    ``DataInvalid``."""
    with open(path, newline='') as f:
        rows = [r for r in csv.reader(f) if any(c.strip() for c in r)]
    if names is None:
        if not rows:
            raise DataInvalid('%s: no header line' % path)
        header, rows = rows[0], rows[1:]
    else:
        header = list(names)
    for i, r in enumerate(rows):
        if len(r) > len(header):
            raise DataInvalid('%s: data row %d has %d fields, the header %d'
                              % (path, i + 1, len(r), len(header)))
    rows = [r + [''] * (len(header) - len(r)) for r in rows]
    return {h: _column([r[j] for r in rows]) for j, h in enumerate(header)}
