"""Configuration: dataclasses <-> config.yaml, without pyyaml.

The fields are those of ``panagram_tpu.config`` (the reference-compatible
schema), so either package reads the other's ``config.yaml``.  The file is
written by a small emitter for the subset of YAML this schema uses (scalars,
one level of nested mappings, lists of scalars) whose output equals
``yaml.dump(cfg.to_dict())`` byte for byte.  ``load_yaml`` reads it back, and
reads the introgression pipeline's configs too: block mappings and lists,
flow lists of scalars, comments; anything else raises.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional


@dataclasses.dataclass
class KMCParams:
    """Counting-stage knobs (name kept for config compatibility with the
    reference's KMC section)."""

    memory: int = 8
    threads: int = 1
    use_existing: bool = False


@dataclasses.dataclass
class UMAPParams:
    neighbors: int = 4
    dist: float = 0
    eps: float = 1
    samples: int = 1
    bin_size: int = 100000


@dataclasses.dataclass
class IndexConfig:
    """Pan-kmer index parameters (same fields as panagram_tpu's)."""

    input: Optional[str] = None
    mode: Optional[str] = None
    prefix: Optional[str] = None
    k: int = 21
    cores: int = 1
    lowres_step: int = 100
    max_bin_kbp: int = 200
    min_bin_count: int = 100
    max_view_chrs: int = 50
    gff_gene_types: List[str] = dataclasses.field(default_factory=lambda: ["gene"])
    gff_anno_types: Optional[List[str]] = None
    gff_name: str = "Name"
    anchor_genomes: Optional[List[str]] = None
    prepare: bool = False
    kmc: KMCParams = dataclasses.field(default_factory=KMCParams)
    genome_umap: UMAPParams = dataclasses.field(default_factory=UMAPParams)
    chrom_umap: UMAPParams = dataclasses.field(default_factory=UMAPParams)
    use_existing: int = 1
    threads: int = 1
    memory: int = 1

    @property
    def steps(self):
        """Bitmap resolutions: full and the low-resolution stride."""
        return (1, self.lowres_step)

    def to_dict(self, exclude=("prefix",)):
        d = dataclasses.asdict(self)
        for key in exclude:
            d.pop(key, None)
        return d

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(dump_yaml(self.to_dict()))

    def update_from_dict(self, vals: dict):
        for key, val in vals.items():
            cur = getattr(self, key, None)
            if dataclasses.is_dataclass(cur) and isinstance(val, dict):
                for k2, v2 in val.items():
                    setattr(cur, k2, v2)
            else:
                setattr(self, key, val)

    @classmethod
    def load(cls, path: str) -> "IndexConfig":
        cfg = cls()
        with open(path) as f:
            cfg.update_from_dict(load_yaml(f.read()))
        return cfg


def config_path(prefix: str) -> str:
    return os.path.join(prefix, "config.yaml")


def samples_path(prefix: str) -> str:
    return os.path.join(prefix, "samples.tsv")


# ---------------------------------------------------------------------------
# YAML subset.  A plain string must be quoted when YAML 1.1's implicit
# resolvers would read it back as another type; these are pyyaml's patterns.
# ---------------------------------------------------------------------------

_IMPLICIT = [re.compile(p, re.X) for p in (
    r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE
        |on|On|ON|off|Off|OFF)$""",
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    r"^(?:<<)$",
    r"^(?:~|null|Null|NULL|)$",
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
        (?:[Tt]|[ \t]+)[0-9][0-9]?
        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    r"^(?:=)$",
    r"^(?:!|&|\*)$",
)]
# characters that keep a scalar plain in block context; anything else is
# single-quoted (a superset of what pyyaml quotes, for the names, paths and
# GFF terms this schema holds)
_PLAIN = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./+-]*$|^-[A-Za-z0-9_./][A-Za-z0-9_./+-]*$")


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    s = str(v)
    if _PLAIN.match(s) and not any(p.match(s) for p in _IMPLICIT):
        return s
    return "'" + s.replace("'", "''") + "'"


def dump_yaml(d: dict) -> str:
    """Block-style YAML with sorted keys, as yaml.dump writes a dict of
    scalars, lists of scalars and dicts of scalars."""
    out = []

    def emit(mapping, indent):
        pad = " " * indent
        for key in sorted(mapping):
            v = mapping[key]
            if isinstance(v, dict):
                if v:
                    out.append(f"{pad}{key}:")
                    emit(v, indent + 2)
                else:
                    out.append(f"{pad}{key}: {{}}")
            elif isinstance(v, (list, tuple)):
                if v:
                    out.append(f"{pad}{key}:")
                    out.extend(f"{pad}- {_scalar(x)}" for x in v)
                else:
                    out.append(f"{pad}{key}: []")
            else:
                out.append(f"{pad}{key}: {_scalar(v)}")

    emit(d, 0)
    return "\n".join(out) + "\n"


def _int(s: str) -> int:
    """A YAML 1.1 int as pyyaml resolves it: underscores dropped, 0b / 0x /
    leading-0 octal bases."""
    t = s.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t[0] == "0":
        return sign * int(t, 8)
    return sign * int(t)


class _Unsupported(ValueError):
    pass


def _parse_scalar(s: str):
    """One scalar of the subset, typed as yaml.safe_load types it: quoted
    strings, null / ~, booleans, ints, floats, [] and {}, else a plain
    string.  Raises _Unsupported for what the subset leaves out (aliases,
    anchors, tags, block scalars, timestamps, sexagesimals, escapes)."""
    if s.startswith("'"):
        if len(s) < 2 or not s.endswith("'") or "'" in s[1:-1].replace("''", ""):
            raise _Unsupported("a single-quoted string must end the value")
        return s[1:-1].replace("''", "'")
    if s.startswith('"'):
        if len(s) < 2 or not s.endswith('"') or '"' in s[1:-1]:
            raise _Unsupported("a double-quoted string must end the value")
        if "\\" in s:
            raise _Unsupported("escapes in double-quoted strings")
        return s[1:-1]
    if s == "[]":
        return []
    if s == "{}":
        return {}
    if s[0] in "&*!|>%@`{[]}," or s.startswith("- ") or s == "-":
        raise _Unsupported(f"{s[0]!r} starts no scalar of the subset")
    if ": " in s or s.endswith(":") or " #" in s:
        raise _Unsupported("a plain value holds ': ' or ' #'")
    if _IMPLICIT[4].match(s):
        return None
    if _IMPLICIT[0].match(s):
        return s.lower() in ("yes", "true", "on")
    if _IMPLICIT[2].match(s):
        if ":" in s:
            raise _Unsupported("sexagesimal ints")
        return _int(s)
    if _IMPLICIT[1].match(s):
        if ":" in s:
            raise _Unsupported("sexagesimal floats")
        low = s.lower().replace("_", "")
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(low)
    if any(p.match(s) for p in _IMPLICIT[3:]):
        raise _Unsupported("timestamps, merge keys and YAML's '=' value")
    return s


def _flow_list(s: str) -> list:
    """A flow list of scalars, [a, 'b', 0.8]."""
    items, cur, quote = [], "", None
    for ch in s[1:-1]:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            cur += ch
            quote = ch
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        elif ch in "[]{}":
            raise _Unsupported("nested flow collections")
        else:
            cur += ch
    if quote:
        raise _Unsupported("an unterminated quoted string")
    items.append(cur.strip())
    if items == [""]:
        return []
    if items[-1] == "":
        items.pop()     # a trailing comma
    if "" in items:
        raise _Unsupported("an empty flow list item")
    return [_parse_scalar(x) for x in items]


def _value(s: str):
    if s.startswith("[") and s.endswith("]"):
        return _flow_list(s)
    return _parse_scalar(s)


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at its start or after a blank,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:[,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def load_yaml(text: str) -> dict:
    """Parse block-style YAML of mappings, lists of scalars and scalars, as
    yaml.safe_load reads it: nested mappings at any depth, block lists whose
    '- ' items sit at their key's indentation or deeper, flow lists of
    scalars, null / ~, booleans, ints, floats, quoted strings and trailing
    comments (what dump_yaml writes, and the introgression configs as users
    write them).  Anything outside that subset raises a ValueError naming
    the line."""
    root: dict = {}
    # open containers: (indent of their entries, dict or list); a "key:"
    # line leaves `pending` for the next line to decide what it holds
    stack: list = [(0, root)]
    pending = None          # (parent dict, key, indent of the key)
    lines = [(n, _strip_comment(raw)) for n, raw in
             enumerate(text.splitlines(), 1)]
    lines = [(n, ln) for n, ln in lines if ln.strip()]
    if lines and lines[0][1] == "---":
        lines = lines[1:]
    for n, raw in lines:
        try:
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise _Unsupported("tabs in the indentation")
            indent = len(raw) - len(raw.lstrip(" "))
            line = raw.strip()
            item = line == "-" or line.startswith("- ")
            if pending is not None:
                parent, key, kind = pending
                pending = None
                if item and indent >= kind:
                    parent[key] = []
                    stack.append((indent, parent[key]))
                elif not item and indent > kind:
                    parent[key] = {}
                    stack.append((indent, parent[key]))
            while stack and indent < stack[-1][0]:
                stack.pop()
            if not stack or indent != stack[-1][0]:
                raise _Unsupported("the indentation matches no open block")
            cont = stack[-1][1]
            if item:
                if not isinstance(cont, list):
                    raise _Unsupported("a list item where a key belongs")
                cont.append(_value(line[2:].strip()) if line != "-" else None)
                continue
            if isinstance(cont, list):
                # a key after a list's items closes the list
                stack.pop()
                if not stack or indent != stack[-1][0] \
                        or isinstance(stack[-1][1], list):
                    raise _Unsupported("a key inside a list")
                cont = stack[-1][1]
            key, sep, val = line.partition(":")
            if not sep or (val and val[0] != " "):
                raise _Unsupported("neither 'key: value' nor '- item'")
            key = key.strip()
            if not key or key[0] in "'\"&*!|>%@`{[?-" or " #" in key:
                raise _Unsupported(f"the key {key!r}")
            val = val.strip()
            if val:
                cont[key] = _value(val)
            else:
                # "key:" opens a mapping or a list, or is null
                cont[key] = None
                pending = (cont, key, indent)
        except _Unsupported as e:
            raise ValueError(f"YAML line {n} is outside the subset this "
                             f"reader takes ({e}): {raw.strip()!r}") from None
    return root
