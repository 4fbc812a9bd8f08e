"""Minimal TOML-subset reader for the port's analysis contract files
(the port's own copy of the reference's ``analysis/toml_lite.py``).

The repo grows no third-party dependency and the port imports nothing
of the reference, so the checked-in contract files
(``compile_sites.toml``, ``artifact_contracts.toml``) are restricted to
the subset this reader supports:

* ``[table]`` and ``[[array-of-tables]]`` headers, including dotted
  paths (``[a.b.c]``, ``[[a.b]]``) with standard TOML relative-path
  semantics: an intermediate segment that names an array of tables
  resolves to its LAST element, so ``[[artifact.unit]]`` followed by
  ``[artifact.unit.measured]`` nests the sub-table under the unit just
  declared;
* ``key = value`` pairs with string (basic, double-quoted), integer,
  float, boolean and flat-array values;
* full-line and trailing ``#`` comments.

That subset is exactly what a declarative contract file needs; anything
fancier in the registry is a smell, so the parser raising on unknown
syntax is a feature. The analyzer's own tests round-trip the shipped
registry through this reader.
"""
from __future__ import annotations


class TomlError(ValueError):
    """Raised on syntax outside the supported TOML subset."""


def _parse_scalar(tok: str, where: str):
    tok = tok.strip()
    if not tok:
        raise TomlError(f"{where}: empty value")
    if tok.startswith('"'):
        if not tok.endswith('"') or len(tok) < 2:
            raise TomlError(f"{where}: unterminated string {tok!r}")
        body = tok[1:-1]
        # the only escapes the registry needs
        return (body.replace('\\"', '"').replace("\\\\", "\\")
                .replace("\\n", "\n").replace("\\t", "\t"))
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        raise TomlError(f"{where}: unsupported value {tok!r}") from None


def _split_array(body: str, where: str) -> list:
    """Split a flat-array body on commas outside strings."""
    items, cur, in_str, prev = [], [], False, ""
    for ch in body:
        if ch == '"' and prev != "\\":
            in_str = not in_str
        if ch == "," and not in_str:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if in_str:
        raise TomlError(f"{where}: unterminated string in array")
    items.append("".join(cur))
    return [_parse_scalar(t, where) for t in items if t.strip()]


def _strip_comment(line: str) -> str:
    out, in_str, prev = [], False, ""
    for ch in line:
        if ch == '"' and prev != "\\":
            in_str = not in_str
        if ch == "#" and not in_str:
            break
        out.append(ch)
        prev = ch
    return "".join(out).strip()


def _descend(root: dict, parts: list, where: str) -> dict:
    """Walk a dotted header path, creating intermediate tables. A
    segment that resolves to an array of tables continues into its
    last element (standard TOML array-of-tables nesting)."""
    cur = root
    for p in parts:
        nxt = cur.setdefault(p, {})
        if isinstance(nxt, list):
            if not nxt:
                raise TomlError(f"{where}: {p} is an empty table array")
            nxt = nxt[-1]
        if not isinstance(nxt, dict):
            raise TomlError(f"{where}: {p} is not a table")
        cur = nxt
    return cur


def _split_path(name: str, where: str) -> list:
    parts = [p.strip() for p in name.split(".")]
    if not all(parts):
        raise TomlError(f"{where}: bad dotted header {name!r}")
    return parts


def loads(text: str) -> dict:
    """Parse the supported TOML subset into nested dicts/lists."""
    root: dict = {}
    table = root
    pending_key = None     # multi-line array accumulation
    pending_val: list[str] = []
    for ln, raw in enumerate(text.splitlines(), 1):
        where = f"line {ln}"
        line = _strip_comment(raw)
        if pending_key is not None:
            pending_val.append(line)
            joined = " ".join(pending_val)
            if joined.rstrip().endswith("]"):
                body = joined.strip()[1:-1]
                table[pending_key] = _split_array(body, where)
                pending_key, pending_val = None, []
            continue
        if not line:
            continue
        if line.startswith("[["):
            if not line.endswith("]]"):
                raise TomlError(f"{where}: bad table-array header")
            parts = _split_path(line[2:-2].strip(), where)
            parent = _descend(root, parts[:-1], where)
            arr = parent.setdefault(parts[-1], [])
            if not isinstance(arr, list):
                raise TomlError(
                    f"{where}: {parts[-1]} is not a table array")
            table = {}
            arr.append(table)
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise TomlError(f"{where}: bad table header")
            parts = _split_path(line[1:-1].strip(), where)
            parent = _descend(root, parts[:-1], where)
            table = parent.setdefault(parts[-1], {})
            if not isinstance(table, dict):
                raise TomlError(
                    f"{where}: {parts[-1]} redefined as table")
            continue
        if "=" not in line:
            raise TomlError(f"{where}: expected key = value, got {line!r}")
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if not key:
            raise TomlError(f"{where}: empty key")
        if val.startswith("["):
            if val.endswith("]"):
                table[key] = _split_array(val[1:-1], where)
            else:                      # array continued on later lines
                pending_key, pending_val = key, [val]
            continue
        table[key] = _parse_scalar(val, where)
    if pending_key is not None:
        raise TomlError(f"unterminated array for key {pending_key!r}")
    return root


def load(path) -> dict:
    from pathlib import Path
    return loads(Path(path).read_text())
