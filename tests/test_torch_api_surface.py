"""panagram_tpu's public surface, name by name, against the port.

Both packages are parsed with ``ast``; neither is imported.  The surface
of a panagram_tpu module is its public module-level functions, classes
and constants, the public methods, properties and class attributes of its
public classes (a dataclass without an ``__init__`` has the constructor of
its fields), and, for a package's ``__init__.py``, the names it re-exports.
Modules whose file name starts with an underscore (``native/_build.py``)
are private and not part of it.

For every name of a panagram_tpu module (one parametrised case per
module), either the port's module at the same relative path binds it (a
definition, or an import whose target is resolved inside the port) and,
for a function, a method or a constructor, panagram_tpu's parameters are
the prefix of its own: in order, by name, with the same defaults, its
keyword-only parameters present with their defaults, and ``*args`` /
``**kwargs`` where panagram_tpu takes them; or LEDGER names it with one
of the REASONS and, where there is one, its replacement in the port.

The test fails on a name that is neither, and on a ledger entry that is
stale: one that names something panagram_tpu no longer has, or something
the port now has with panagram_tpu's parameters.  A ledger entry may name
a port function of the same name and another contract (the mesh
helpers, whose first argument is the port's Mesh).

``python tests/test_torch_api_surface.py`` prints the ledger grouped by
reason, the form ROADMAP.md's "Never ported" list copies.
"""

from __future__ import annotations

import ast
import operator
import os
from collections import defaultdict

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "panagram_tpu"
PORT_PKG = "panagram_tpu_torch"

RIG = "TPU-rig workaround"
RLE = "RLE wire format (the run-length transfers, struck)"
SHARDING = "jax.sharding object (the port's rank model replaces it)"
PALLAS = "the Pallas module itself (the kernels live in ops/kernels.py)"
PANDAS = "pandas-DataFrame contract (the port takes arrays / Table)"
REASONS = (RIG, RLE, SHARDING, PALLAS, PANDAS)

# "module path:name" -> (reason, the port's replacement or None)
LEDGER = {
    # ops/pallas_kernels.py: the Pallas kernels and their switches
    "ops/pallas_kernels.py:TILE": (PALLAS, None),
    "ops/pallas_kernels.py:TILE_Q": (PALLAS, "ops/lookup.TILE_Q"),
    "ops/pallas_kernels.py:SPAN": (PALLAS, "ops/lookup.plan_probe(span=)"),
    "ops/pallas_kernels.py:pallas_enabled": (
        PALLAS, "none needed: a wrapper launches its kernel on a CUDA "
        "tensor"),
    "ops/pallas_kernels.py:fused_popcount_colsums": (
        PALLAS, "ops/kernels.fused_popcount_colsums"),
    "ops/pallas_kernels.py:probe_sorted": (PALLAS, "ops/kernels.probe_sorted"),
    "ops/pallas_kernels.py:pack_mix_pallas": (PALLAS, "ops/kernels.pack_mix"),
    "ops/pallas_kernels.py:pack_mix_positions": (
        PALLAS, "none needed: ops/kernels.pack_mix emits positional order"),
    "ops/pallas_kernels.py:masks_to_bytes_pallas": (
        PALLAS, "ops/kernels.masks_to_bytes"),
    # ops/prewarm.py: ahead-of-time compiles of the TPU rig
    "ops/prewarm.py:logger": (RIG, None),
    "ops/prewarm.py:enabled": (RIG, None),
    "ops/prewarm.py:submit": (RIG, None),
    "ops/prewarm.py:get_compiled": (RIG, None),
    "ops/prewarm.py:wait_all": (RIG, None),
    "ops/prewarm.py:prewarm_dict_programs": (RIG, None),
    "ops/prewarm.py:prewarm_anchor_programs": (RIG, None),
    # ops/lookup.py
    "ops/lookup.py:row_pack": (
        RIG, "none: tables stay [B, stride]; the probes take the packed-row "
        "form"),
    "ops/lookup.py:hbm_limit_bytes": (
        RIG, "ops/lookup.check_device_budget (the card's free memory)"),
    # ops/devdict.py
    "ops/devdict.py:slice_fn": (RIG, None),
    "ops/devdict.py:flat_fn": (RIG, None),
    # ops/anchor.py: the run-length transfers and their host decoders
    "ops/anchor.py:rle_row_bytes": (RLE, None),
    "ops/anchor.py:rle_payload": (RLE, None),
    "ops/anchor.py:anchor_chunk_rle2": (RLE, "ops/anchor.anchor_chunk_fast"),
    "ops/anchor.py:PAL_CAP": (RLE, None),
    "ops/anchor.py:rle4_pal_bytes": (RLE, None),
    "ops/anchor.py:pal_work_for": (RLE, None),
    "ops/anchor.py:rle4_payload": (RLE, None),
    "ops/anchor.py:anchor_chunk_rle4": (RLE, "ops/anchor.anchor_chunk_fast"),
    "ops/anchor.py:unpack_rle2": (RLE, None),
    "ops/anchor.py:rle2_colsums": (RLE, None),
    "ops/anchor.py:rle4_colsums": (RLE, None),
    "ops/anchor.py:rle2_popc": (RLE, None),
    "ops/anchor.py:rle4_popc": (RLE, None),
    "ops/anchor.py:DECODE_WORKERS": (RLE, None),
    "ops/anchor.py:dispatch_rle_prefix": (RLE, None),
    "ops/anchor.py:collect_rle2": (RLE, None),
    "ops/anchor.py:dispatch_rle4_prefix": (RLE, None),
    "ops/anchor.py:collect_rle4": (RLE, None),
    "ops/anchor.py:rle4_to_v3_rows": (RLE, None),
    "ops/anchor.py:unpack_rle4": (RLE, None),
    "ops/anchor.py:rle_proto": (RLE, None),
    "ops/anchor.py:piece_fn": (RIG, None),
    # native/anchor_cpu.py: host decoders of the run-length formats
    "native/anchor_cpu.py:rle_expand_native": (RLE, None),
    "native/anchor_cpu.py:rle_expand_pal_native": (RLE, None),
    # parallel/: the device mesh and the sharded engines' transfers
    "parallel/__init__.py:make_mesh": (SHARDING, "parallel.Mesh / launch"),
    "parallel/__init__.py:DICT_AXIS": (SHARDING, "parallel.Mesh / launch"),
    "parallel/mesh.py:make_mesh": (SHARDING, "parallel/mesh.launch"),
    "parallel/mesh.py:DICT_AXIS": (SHARDING, "parallel/mesh.Mesh"),
    "parallel/mesh.py:host_view": (
        SHARDING, "none needed: a rank's tensors are its own"),
    "parallel/mesh.py:initialize_distributed": (
        SHARDING, "parallel/mesh.launch, which calls join_mesh on each "
        "rank"),
    "parallel/mesh.py:assert_lockstep": (
        SHARDING, "parallel/mesh.check_lockstep(mesh, tag, value)"),
    "parallel/shard.py:ShardedBucketedDict.__init__": (
        SHARDING, "parallel/shard.ShardedBucketedDict(table, ...): this "
        "rank's shard"),
    "parallel/shard.py:ShardedBucketedDict.tables": (
        SHARDING, "ShardedBucketedDict.table, this rank's shard"),
    "parallel/shard.py:GenomeShardedDict.__init__": (
        SHARDING, "parallel/shard.GenomeShardedDict(table, ...): this "
        "rank's mask-word slice"),
    "parallel/shard.py:GenomeShardedDict.tables": (
        SHARDING, "GenomeShardedDict.table, this rank's slice"),
    "parallel/shard.py:sharded_anchor_chunk": (
        RLE, "parallel/shard.sharded_anchor_chunk(mesh, sbd, codes_slice): "
        "this rank's dense rows"),
    "parallel/shard.py:sharded_anchor_chunk_pal": (
        RLE, "parallel/shard.sharded_anchor_chunk"),
    "parallel/shard.py:genome_sharded_anchor_chunk_pal": (
        RLE, "parallel/shard.genome_sharded_anchor_chunk"),
    "parallel/shard.py:prefix_rows": (RLE, None),
    # DataFrame contracts: the port's functions take arrays and Tables
    "umap_embed.py:run_embedding": (
        PANDAS, "umap_embed.run_embedding(chroms, starts, data, params, "
        "genome_name)"),
    "intros/call.py:edge_tapered_row_normalization": (
        PANDAS, "intros/call.edge_tapered_row_normalization(values, "
        "intensity)"),
    "intros/call.py:similarity_frame": (
        PANDAS, "intros/call.similarity_frame(binned, groups, anchor, "
        "comp_group)"),
    "intros/core.py:bed_to_bins": (PANDAS, "intros/core.bed_to_bins(bed, ...)"),
    "intros/core.py:bins_to_bed": (
        PANDAS, "intros/core.bins_to_bed(bins, ...)"),
    "intros/core.py:merge_centromere_regions": (
        PANDAS, "intros/core.merge_centromere_regions(bed, ...)"),
    "intros/score.py:threshold_matrices": (
        PANDAS, "intros/score.threshold_matrices(pred, gt, threshold)"),
    "intros/score.py:score_introgressions": (
        PANDAS, "intros/score.score_introgressions(pred, gt)"),
    "intros/score.py:create_scored_heatmap": (
        PANDAS, "intros/score.create_scored_heatmap(pred, gt, ...)"),
    "intros/score.py:rescale_prediction_row": (
        PANDAS, "intros/score.rescale_prediction_row(row, starts, ...)"),
    "intros/visualize.py:mcc": (PANDAS, "intros/visualize.mcc(tp, tn, fp, fn)"),
    "intros/visualize.py:pr_auc": (
        PANDAS, "intros/visualize.pr_auc(precision, recall)"),
}

_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.LShift: operator.lshift,
        ast.RShift: operator.rshift, ast.BitOr: operator.or_,
        ast.BitAnd: operator.and_, ast.Pow: operator.pow}


class Module:
    """One parsed module: its public bindings and its constants."""

    def __init__(self, pkg: str, rel: str):
        self.pkg, self.rel = pkg, rel
        path = os.path.join(ROOT, pkg, rel)
        with open(path) as f:
            self.src = f.read()
        self.tree = ast.parse(self.src)
        self.consts = {}
        self.defs = {}        # name -> FunctionDef / ClassDef / "const"
        self.imports = {}     # name -> (module rel path or None, name)
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                self.defs[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.defs[t.id] = "const"
                        if node.value is not None:
                            self.consts[t.id] = node.value
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.imports[a.asname or a.name] = (
                        self._resolve(node), a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[(a.asname or a.name).split(".")[0]] = (
                        None, a.name)

    def _resolve(self, node: ast.ImportFrom):
        """The relative path of an in-package import's module, or of the
        package whose attribute it names; None outside the package."""
        if not node.level:
            return None
        base = os.path.dirname(self.rel).split(os.sep) if \
            os.path.dirname(self.rel) else []
        base = base[:len(base) - (node.level - 1)] if node.level > 1 \
            else base
        parts = base + (node.module.split(".") if node.module else [])
        return os.path.join(*parts) if parts else ""

    def value(self, expr):
        """A default's value where it is a constant expression (names
        resolved to this module's constants), else its source text."""
        try:
            return ("value", self._eval(expr))
        except (ValueError, KeyError, TypeError):
            return ("source", ast.get_source_segment(self.src, expr))

    def _eval(self, e):
        if isinstance(e, ast.Constant):
            return e.value
        if isinstance(e, ast.Name):
            return self._eval(self.consts[e.id])
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            return -self._eval(e.operand)
        if isinstance(e, ast.BinOp) and type(e.op) in _OPS:
            return _OPS[type(e.op)](self._eval(e.left), self._eval(e.right))
        if isinstance(e, ast.Tuple):
            return tuple(self._eval(x) for x in e.elts)
        raise ValueError(ast.dump(e))


_MODULES: dict = {}


def module(pkg: str, rel: str):
    key = (pkg, rel)
    if key not in _MODULES:
        path = os.path.join(ROOT, pkg, rel)
        _MODULES[key] = Module(pkg, rel) if os.path.isfile(path) else None
    return _MODULES[key]


def _module_rel(pkg: str, rel: str):
    """`rel` (a path without .py) as a module file of pkg, or None."""
    for cand in (rel + ".py", os.path.join(rel, "__init__.py")):
        if os.path.isfile(os.path.join(ROOT, pkg, cand)):
            return cand
    return None


def is_dataclass(cls: ast.ClassDef) -> bool:
    return any("dataclass" in ast.unparse(d) for d in cls.decorator_list)


def signature(mod: Module, fn):
    """(positional [(name, default)], keyword-only {name: default},
    *args, **kwargs) of a FunctionDef, or of a dataclass's generated
    constructor (a ClassDef)."""
    if isinstance(fn, ast.ClassDef):
        pos = [("self", None)]
        for b in fn.body:
            if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                pos.append((b.target.id, None if b.value is None
                            else mod.value(b.value)))
        return pos, {}, False, False
    a = fn.args
    args = a.posonlyargs + a.args
    dflt = [None] * (len(args) - len(a.defaults)) + [
        mod.value(d) for d in a.defaults]
    kw = {x.arg: (None if d is None else mod.value(d))
          for x, d in zip(a.kwonlyargs, a.kw_defaults)}
    return ([(x.arg, d) for x, d in zip(args, dflt)], kw,
            a.vararg is not None, a.kwarg is not None)


def class_members(mod: Module, cls: ast.ClassDef) -> dict:
    """name -> FunctionDef or "attr": the public methods (and __init__),
    properties and class-level names of a class and its in-module bases;
    a dataclass without __init__ gets its fields' constructor."""
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name) and isinstance(
                mod.defs.get(base.id), ast.ClassDef):
            out.update(class_members(mod, mod.defs[base.id]))
    for b in cls.body:
        if isinstance(b, ast.FunctionDef):
            if b.name == "__init__" or not b.name.startswith("_"):
                prop = any(ast.unparse(d).endswith(("property", "setter"))
                           for d in b.decorator_list)
                out[b.name] = "attr" if prop else b
        elif isinstance(b, (ast.Assign, ast.AnnAssign)):
            for t in (b.targets if isinstance(b, ast.Assign) else [b.target]):
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = "attr"
    if "__init__" not in out and is_dataclass(cls):
        out["__init__"] = cls
    return out


def surface(mod: Module) -> dict:
    """panagram_tpu's public surface of a module: "name" or
    "Class.member" -> the ClassDef / FunctionDef / "const" / "attr"."""
    out = {}
    for name, d in mod.defs.items():
        if name.startswith("_"):
            continue
        out[name] = d
        if isinstance(d, ast.ClassDef):
            for m, v in class_members(mod, d).items():
                out[f"{name}.{m}"] = v
    if os.path.basename(mod.rel) == "__init__.py":
        for name, (src, _) in mod.imports.items():
            if src is not None and not name.startswith("_"):
                out.setdefault(name, "reexport")
    return out


def port_binding(rel: str, name: str, depth: int = 0):
    """What the port's module `rel` binds to `name` ("Class.member" looks
    inside the class): (Module, node) with imports followed inside the
    port, (None, "bound") for a binding from outside it, or None."""
    mod = module(PORT_PKG, rel)
    if mod is None or depth > 8:
        return None
    head, _, member = name.partition(".")
    if head in mod.defs:
        d = mod.defs[head]
        if not member:
            return mod, d
        if isinstance(d, ast.ClassDef):
            m = class_members(mod, d).get(member)
            return None if m is None else (mod, m)
        return None
    if head in mod.imports:
        src, orig = mod.imports[head]
        if src is None:
            return None if member else (None, "bound")
        target = _module_rel(PORT_PKG, os.path.join(src, orig)) \
            if src != "" or orig else None
        if target is not None and not member:
            return module(PORT_PKG, target), "module"
        target = _module_rel(PORT_PKG, src) if src else "__init__.py"
        if target is None:
            return None
        return port_binding(target, orig + ("." + member if member else ""),
                            depth + 1)
    return None


def mismatch(jmod: Module, jnode, rel: str, name: str):
    """Why the port's binding of `name` does not carry panagram_tpu's
    contract, or None when it does."""
    got = port_binding(rel, name)
    if got is None:
        return "missing"
    pmod, pnode = got
    if not isinstance(jnode, (ast.FunctionDef, ast.ClassDef)) or \
            isinstance(jnode, ast.ClassDef) and not name.endswith(
                ".__init__"):
        return None
    if not isinstance(pnode, (ast.FunctionDef, ast.ClassDef)):
        return f"bound to {pnode!r}, not a function"
    jpos, jkw, jva, jkwa = signature(jmod, jnode)
    ppos, pkw, pva, pkwa = signature(pmod, pnode)
    if [n for n, _ in ppos[:len(jpos)]] != [n for n, _ in jpos]:
        return (f"parameters {[n for n, _ in ppos]} do not begin with "
                f"panagram_tpu's {[n for n, _ in jpos]}")
    for (n, jd), (_, pd) in zip(jpos, ppos):
        if jd != pd:
            return f"default of {n}: {pd} where panagram_tpu has {jd}"
    everything = dict(ppos, **pkw)
    for n, jd in jkw.items():
        if n not in everything:
            return f"no keyword {n}"
        if everything[n] != jd:
            return f"default of {n}: {everything[n]} where panagram_tpu " \
                   f"has {jd}"
    if (jva and not pva) or (jkwa and not pkwa):
        return "no *args / **kwargs"
    return None


def jax_modules() -> list[str]:
    out = []
    base = os.path.join(ROOT, JAX_PKG)
    for dp, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py") and (not f.startswith("_") or f in (
                    "__init__.py", "__main__.py", "__about__.py")):
                out.append(os.path.relpath(os.path.join(dp, f), base))
    return sorted(out)


def _ledger_keys(rel: str):
    return {k.split(":", 1)[1] for k in LEDGER if k.split(":", 1)[0] == rel}


@pytest.mark.parametrize("rel", jax_modules())
def test_port_module_carries_panagram_tpu_surface(rel):
    """Every public name of the panagram_tpu module is in the port's module
    at the same path with panagram_tpu's parameters first, or in LEDGER."""
    jmod = module(JAX_PKG, rel)
    ledgered = _ledger_keys(rel)
    missing = {}
    for name, node in surface(jmod).items():
        why = mismatch(jmod, node, rel, name)
        if why is not None and name not in ledgered:
            missing[name] = why
    assert not missing, f"{rel}: names without panagram_tpu's contract " \
        f"on the port and no ledger entry: {missing}"


def test_ledger_is_current():
    """Each ledger entry names a panagram_tpu name that the port does not
    carry with panagram_tpu's parameters, with one of the REASONS."""
    stale = {}
    for key, (reason, _) in LEDGER.items():
        rel, name = key.split(":", 1)
        assert reason in REASONS, key
        jmod = module(JAX_PKG, rel)
        node = None if jmod is None else surface(jmod).get(name)
        if node is None:
            stale[key] = "panagram_tpu has no such name"
        elif mismatch(jmod, node, rel, name) is None:
            stale[key] = "the port has it with panagram_tpu's parameters"
    assert not stale, stale


def test_surface_walk_sees_the_known_names():
    """The walk finds what it must: a class's method, a property, a
    dataclass constructor, a re-export, an import followed into another
    module and a keyword-only port parameter after panagram_tpu's."""
    lookup = surface(module(JAX_PKG, "ops/lookup.py"))
    assert isinstance(lookup["BucketedDict.build_device"], ast.FunctionDef)
    assert lookup["BucketedDict.MEAN_LOAD"] == "attr"
    assert isinstance(lookup["BucketedDict.__init__"], ast.ClassDef)
    assert surface(module(JAX_PKG, "ops/dictionary.py"))[
        "PanKmerDict.nbytes_row"] == "attr"
    assert surface(module(JAX_PKG, "__init__.py"))["Index"] == "reexport"
    _, node = port_binding("ops/lookup.py", "mix64")
    assert node.name == "mix64"
    _, node = port_binding("ops/anchor.py", "masks_to_bytes")
    assert node.name == "masks_to_bytes"
    jmod = module(JAX_PKG, "ops/count.py")
    node = surface(jmod)["counted_kmers_chunked"]
    assert mismatch(jmod, node, "ops/count.py", "counted_kmers_chunked") \
        is None
    assert mismatch(jmod, node, "ops/codec.py", "pack_kmers") is not None


def ledger_markdown() -> str:
    """The ledger grouped by reason, one bullet per entry."""
    groups = defaultdict(list)
    for key, (reason, repl) in LEDGER.items():
        rel, name = key.split(":", 1)
        groups[reason].append(f"`{rel[:-3]}.{name}`"
                              + (f" → {repl}" if repl else ""))
    lines = []
    for reason in REASONS:
        lines.append(f"- **{reason}** ({len(groups[reason])}): "
                     + "; ".join(groups[reason]) + ".")
    return "\n".join(lines)


if __name__ == "__main__":
    print(ledger_markdown())
