"""Config system: a small self-contained HOCON-subset parser.

The port's own copy of ``avr_tpu/config.py`` (the port imports nothing of
the JAX package); it parses the same ``conf/*.conf`` files.

The reference consumes two HOCON files through ``pyhocon``
(``conf/default.conf``, ``conf/default_mv.conf``; see reference
``train.py:262`` and the ``from_conf`` classmethods, e.g. reference
``models.py:79-87``, ``renderers.py:279-289``).  ``pyhocon`` is not part of
this environment, so we implement the subset actually used:

  * ``key = value`` assignments (bool / int / float / bare or quoted string)
  * nested blocks ``name { ... }`` (brace may open on the key line)
  * ``include required("file.conf")`` file inheritance with recursive
    dict-merge, later keys overriding earlier ones
  * ``#`` and ``//`` comments

The :class:`Conf` wrapper mirrors the pyhocon accessors used by the
reference factories (``get_string/get_int/get_float/get_bool`` and
``conf["sub"]`` sub-tree indexing) so configuration-driven construction has
an identical surface.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

__all__ = ["Conf", "parse_conf", "parse_conf_string", "ConfError"]


class ConfError(ValueError):
    pass


_INCLUDE_RE = re.compile(r'^include\s+required\(\s*"(?P<path>[^"]+)"\s*\)\s*$')
_ASSIGN_RE = re.compile(r"^(?P<key>[A-Za-z_][\w.-]*)\s*[=:]\s*(?P<value>.+)$")
_BLOCK_OPEN_RE = re.compile(r"^(?P<key>[A-Za-z_][\w.-]*)\s*\{\s*$")


def _strip_comment(line: str) -> str:
    # Remove '#' / '//' comments (the subset we parse never embeds these in
    # quoted strings that matter).
    out = []
    i, n = 0, len(line)
    in_quote = False
    while i < n:
        ch = line[i]
        if ch == '"':
            in_quote = not in_quote
        if not in_quote:
            if ch == "#":
                break
            if ch == "/" and i + 1 < n and line[i + 1] == "/":
                break
        out.append(ch)
        i += 1
    return "".join(out).strip()


def _parse_scalar(text: str) -> Any:
    text = text.strip()
    if text.startswith('"') and text.endswith('"') and len(text) >= 2:
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text  # bare string


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; `src` wins on conflicts (HOCON semantics)."""
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _split_inline_blocks(line: str):
    """Break inline blocks like ``key { a = 1 }`` into separate lines."""
    pieces = []
    cur = []
    in_quote = False
    for ch in line:
        if ch == '"':
            in_quote = not in_quote
        if not in_quote and ch == "{":
            cur.append("{")
            pieces.append("".join(cur))
            cur = []
        elif not in_quote and ch == "}":
            pieces.append("".join(cur))
            pieces.append("}")
            cur = []
        else:
            cur.append(ch)
    pieces.append("".join(cur))
    return [p.strip() for p in pieces if p.strip()]


def _parse_lines(lines, base_dir: Optional[str]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    stack = [root]
    expanded = []
    for raw in lines:
        stripped = _strip_comment(raw)
        if not stripped:
            continue
        expanded.extend(_split_inline_blocks(stripped))
    for raw in expanded:
        line = raw
        m = _INCLUDE_RE.match(line)
        if m:
            if base_dir is None:
                raise ConfError("include used but no base directory known")
            sub = parse_conf(os.path.join(base_dir, m.group("path")))
            _merge(stack[-1], sub._data)
            continue
        if line == "}":
            if len(stack) == 1:
                raise ConfError("unbalanced '}'")
            stack.pop()
            continue
        m = _BLOCK_OPEN_RE.match(line)
        if m:
            key = m.group("key")
            child = stack[-1].setdefault(key, {})
            if not isinstance(child, dict):
                child = {}
                stack[-1][key] = child
            stack.append(child)
            continue
        m = _ASSIGN_RE.match(line)
        if m:
            stack[-1][m.group("key")] = _parse_scalar(m.group("value"))
            continue
        raise ConfError(f"cannot parse config line: {raw!r}")
    if len(stack) != 1:
        raise ConfError("unbalanced '{' at end of file")
    return root


class Conf:
    """Dict-backed config tree with pyhocon-style typed accessors."""

    def __init__(self, data: Dict[str, Any]):
        self._data = data

    # -- pyhocon-compatible surface ------------------------------------
    def __getitem__(self, key: str) -> "Conf":
        v = self._lookup(key)
        if isinstance(v, dict):
            return Conf(v)
        raise KeyError(f"{key} is not a config subtree")

    def __contains__(self, key: str) -> bool:
        try:
            self._lookup(key)
            return True
        except KeyError:
            return False

    def get(self, key: str, default: Any = None) -> Any:
        try:
            v = self._lookup(key)
        except KeyError:
            return default
        return Conf(v) if isinstance(v, dict) else v

    def get_string(self, key: str, default: Optional[str] = None) -> str:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        return str(v)

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        return int(v)

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        return float(v)

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return bool(v)

    # ------------------------------------------------------------------
    def _lookup(self, dotted: str) -> Any:
        node: Any = self._data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(dotted)
            node = node[part]
        return node

    def as_dict(self) -> Dict[str, Any]:
        return self._data

    def __repr__(self) -> str:
        return f"Conf({self._data!r})"


def parse_conf(path: str) -> Conf:
    """Parse a HOCON-subset config file (with ``include required`` support)."""
    with open(path, "r") as f:
        lines = f.readlines()
    return Conf(_parse_lines(lines, os.path.dirname(os.path.abspath(path))))


def parse_conf_string(text: str, base_dir: Optional[str] = None) -> Conf:
    return Conf(_parse_lines(text.splitlines(), base_dir))
