"""Configuration: dataclasses <-> config.yaml, without pyyaml.

The fields are those of ``panagram_tpu.config`` (the reference-compatible
schema), so either package reads the other's ``config.yaml``.  The file is
written by a small emitter for the subset of YAML this schema uses (scalars,
one level of nested mappings, lists of scalars) whose output equals
``yaml.dump(cfg.to_dict())`` byte for byte, and read back by a parser of that
same subset.
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


def _parse_scalar(s: str):
    if s.startswith("'") and s.endswith("'") and len(s) >= 2:
        return s[1:-1].replace("''", "'")
    if s.startswith('"') and s.endswith('"') and len(s) >= 2:
        return s[1:-1]
    if s == "[]":
        return []
    if s == "{}":
        return {}
    if _IMPLICIT[4].match(s):
        return None
    if _IMPLICIT[0].match(s):
        return s.lower() in ("yes", "true", "on")
    if _IMPLICIT[2].match(s):
        try:
            return int(s.replace("_", ""), 0)
        except ValueError:
            return s
    if _IMPLICIT[1].match(s):
        low = s.lower().replace("_", "")
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        try:
            return float(low)
        except ValueError:
            return s
    return s


def load_yaml(text: str) -> dict:
    """Parse the block-style subset dump_yaml writes (and yaml.dump writes
    for this schema): top-level keys, one level of nested mappings, and
    lists of scalars whose '- ' items sit at their key's indentation."""
    root: dict = {}
    parent: dict = root          # mapping that takes "key: value" lines
    pending = None               # (container, key) of a "key:" line
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        line = raw.strip()
        if indent == 0 and not line.startswith("- "):
            parent = root
        if line.startswith("- "):
            if pending is None:
                raise ValueError(f"config.yaml: list item without key: {raw!r}")
            cont, key = pending
            if not isinstance(cont[key], list):
                cont[key] = []
            cont[key].append(_parse_scalar(line[2:].strip()))
            continue
        key, sep, val = line.partition(":")
        if not sep:
            raise ValueError(f"config.yaml: cannot parse line {raw!r}")
        val = val.strip()
        target = root if indent == 0 else parent
        if val:
            target[key] = _parse_scalar(val)
            pending = None
        else:
            # "key:" opens a nested mapping or a list; the next line decides
            target[key] = {}
            pending = (target, key)
            if indent == 0:
                parent = target[key]
    return root
