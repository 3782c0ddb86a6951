"""Runs one cell of BENCHMARK.json on the card and prints its result line.

    python3 -m portbench.run --workload <config>.<mix> --seed N \
        --seconds S --trace 0|1

From the root of a checkout.  Set-up (imports, CUDA, the kernels' build
or load, generation, the program's table, warm-up) is timed from the
start of the process; then the window runs for S seconds; then the
program's state is freed and the reference judges what the window
produced.  --trace 1 runs the window under torch.profiler and reports the
cell's per-layer metrics instead of its end-to-end ones.

stderr carries the set-up's split, the card's name and power limit, and
last each compared number beside its limit; the last line of stdout is
the JSON result.  No card, too few cards, or jax or panagram_tpu loaded
once the window has closed: a message on stderr, no result, exit 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the caches of the libraries the program may use, fixed inside the
# checkout (the program's own kernels build into panagram_tpu_torch/_built)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "panagram_tpu")


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_spec(spec: dict, name: str):
    """(workload entry, configuration, traffic mix) of cell `name`."""
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(ROOT, entry["file"]))
    mix = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return cell, cfg, mix


def cell_metrics(spec: dict, name: str, trace: bool) -> list:
    """The metrics a run of cell `name` reports: its end-to-end metrics, or
    with trace its per-layer ones."""
    every = [w["name"] for w in spec["workloads"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", every)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str):
    """The `read(ctx)` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(f"portbench.metrics.{name}",
                                                path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is jax, jaxlib, flax or
    panagram_tpu (compared whole: panagram_tpu_torch is not one)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: none"


def run_cell(name: str, cfg: dict, mix: dict, metrics: list, seed: int,
             seconds: float, trace: bool, device, system=None,
             t_start: float | None = None) -> dict:
    """One run of a cell on `device`, the result's dict.  `system(cell)`,
    when given, changes the set-up cell before the window (the control
    puts the reference in the program's place).  The command line checks
    the card; the tests call this on the CPU."""
    import torch

    from portbench.trace import Trace, no_mark

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.type == "cuda"
    log(f"setup: imports {time.perf_counter() - t_start:.3f} s")
    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        from panagram_tpu_torch import _build

        log(f"setup: cuda init {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        compiled = _build.build()
        log(f"setup: kernel library {time.perf_counter() - t:.3f} s "
            f"(compiled {compiled:.3f} s)")
    kind = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    cell = kind.Cell(cfg, mix, seed, device, log)
    cell.setup()
    if system is not None:
        system(cell)
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {setup_s:.3f} s in all")

    tracer = Trace(device) if trace else None
    with tracer or contextlib.nullcontext():
        mark = tracer.mark if tracer else no_mark
        with mark("portbench.window"):
            win = cell.window(seconds, mark)
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    log(f"window: {win.seconds:.3f} s, {win.attempted} steps")
    summary = None
    if tracer:
        t = time.perf_counter()
        summary = tracer.reduce()
        log(f"trace read: {time.perf_counter() - t:.3f} s")
    cell.free()
    t = time.perf_counter()
    chk = cell.check(least_bytes=trace)
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s")

    ctx = types.SimpleNamespace(kind=mix["kind"], window=win, setup_s=setup_s,
                                peak_bytes=peak, trace=summary,
                                least_bytes=chk.least_bytes, cuda=cuda)
    values = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": max(setup_peak, peak) if cuda else 0}
    result = {"correct": chk.correct and win.attempted > 0,
              "attempted": win.attempted, "failed": chk.failed,
              "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in chk.numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)

    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, cfg, mix = cell_spec(spec, args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is false")
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 1
    result = run_cell(args.workload, cfg, mix,
                      cell_metrics(spec, args.workload, bool(args.trace)),
                      args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=T_START)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 1
    log(f"card: {card_line()}")
    for n, c in result["checks"].items():
        log(f"check {n} = {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
