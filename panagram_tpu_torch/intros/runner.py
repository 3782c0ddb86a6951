"""Introgression pipeline runner: YAML config -> call -> postprocess ->
score -> sweep visualization (the ``intros`` command).

panagram_tpu.intros.runner on the port's read API: the same four-section
config (general / calling / postprocessing / scoring), read by
``config.load_yaml``, the same 18-threshold sweep presets, the
per-threshold postprocess and score fan-out, and the same output layout:

  <output_dir>/<output_dir>_<thr>/{raw,heatmaps,postprocessed,scored}/
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

from ..config import load_yaml
from ..index import Index
from .call import SWEEP_2WAY, SWEEP_3WAY, call_introgressions, read_groups
from .postprocess import postprocess
from .score import score


def parse_config(config_path):
    with open(config_path) as f:
        cfg = load_yaml(f.read())
    for section in ["general", "calling", "postprocessing", "scoring"]:
        cfg.setdefault(section, {})
    return cfg


def run_introgression_pipeline(cfg, sweep=False):
    gen = cfg["general"]
    call_cfg = cfg["calling"]
    post_cfg = cfg["postprocessing"]
    score_cfg = cfg["scoring"]

    output_dir = Path(gen["output_dir"])
    index_dir = Path(gen["index_dir"])
    group_tsv = Path(gen["tsv"])
    bin_size = int(gen.get("bin", 1_000_000))
    ref = gen.get("ref")
    threads = int(gen.get("threads", 1))

    index = Index(str(index_dir))
    groups = read_groups(group_tsv)
    if any(g is not None and "_" in str(g) for g in groups.values()):
        raise ValueError("Group names cannot contain underscores ('_').")

    comp_groups = list(call_cfg.get("cmp") or [])
    thresholds = [float(t) for t in (call_cfg.get("thr") or [])]
    if sweep:
        thresholds = SWEEP_2WAY if comp_groups == ["REF"] else SWEEP_3WAY
        print(f"Running sweep with {len(thresholds)} thresholds")

    if output_dir.exists() and any(output_dir.iterdir()):
        if sys.stdin.isatty():
            ans = input(f"{output_dir} exists and is not empty; overwrite? [y/N] ")
            if ans.lower() != "y":
                print("Aborting.")
                return
        else:
            print(f"Warning: writing into existing {output_dir}")

    # ---- calling ----
    if call_cfg.get("run"):
        anchors = call_cfg.get("anc")
        if anchors is None:
            grp = call_cfg.get("grp")
            if grp is None:
                raise ValueError("calling requires anc or grp")
            if isinstance(grp, str):
                grp = [grp]
            anchors = [n for n, g in groups.items() if g in grp]

        rmu = call_cfg.get("rmu")
        if isinstance(rmu, bool):
            rmu = ["true"] if rmu else None
        elif isinstance(rmu, str):
            rmu = [rmu]

        call_introgressions(
            index, groups, anchors, comp_groups, thresholds, output_dir,
            bitmap_step=int(call_cfg.get("stp", 100)),
            bin_size=bin_size,
            gnm=call_cfg.get("gnm"),
            trm=float(call_cfg.get("trm", 3.0)),
            sft=call_cfg.get("sft"),
            ssz=int(call_cfg.get("ssz", 5)),
            edg=bool(call_cfg.get("edg", False)),
            rmf=bool(call_cfg.get("rmf", False)),
            rmu=rmu,
            ogrp=call_cfg.get("ogrp"),
            urf=bool(call_cfg.get("urf", False)),
            ref=ref,
            chromosomes=call_cfg.get("chr"),
            render_vis=bool(call_cfg.get("vis", False)),
            threads=threads,
        )

    # ---- per-threshold postprocess + score ----
    def run_post_and_score(thr):
        call_dir = output_dir / f"{output_dir.name}_{thr}"
        if not call_dir.exists():
            raise ValueError(f"missing call output {call_dir}")
        post_dir = call_dir / "postprocessed"
        if post_cfg.get("run"):
            beds = sorted((call_dir / "raw").glob("*.bed"))
            postprocess(
                index, beds, post_cfg.get("act") or [], post_dir, ref=ref,
                bin_size=bin_size,
                min_bins=int(post_cfg.get("min", 4)),
                gap_bins=int(post_cfg.get("gap", 1)),
                minimap_flags=post_cfg.get("map") or "-x asm20 -c -t 1",
                paf_dir=post_cfg.get("paf"),
                threads=threads,
            )
        if score_cfg.get("run"):
            src = post_dir if post_cfg.get("run") else call_dir / "raw"
            score(
                index, src, score_cfg["gdt"], ref, call_dir / "scored",
                bin_size=bin_size,
                min_bins=int(score_cfg.get("min", 4) or 4),
                gap_bins=int(score_cfg.get("gap", 1) or 1),
                gt_threshold=float(score_cfg.get("thr", 0.5) or 0.5),
                comp_groups=score_cfg.get("cmp"),
                actions=score_cfg.get("act"),
                render_vis=bool(score_cfg.get("vis", False)),
                groups=groups,
            )

    if post_cfg.get("run") or score_cfg.get("run"):
        n = max(1, min(threads, len(thresholds)))
        with ThreadPoolExecutor(max_workers=n) as ex:
            futures = {ex.submit(run_post_and_score, t): t for t in thresholds}
            for fut in as_completed(futures):
                fut.result()

    # ---- sweep visualization ----
    if score_cfg.get("run") and score_cfg.get("vis") and sweep:
        from . import visualize

        metrics = visualize.load_sweep_metrics(output_dir, thresholds)
        if metrics:
            visualize.plot_pr_curves(metrics, output_dir)
            visualize.plot_per_chr_pr(metrics, output_dir)
            visualize.plot_mcc(metrics, output_dir)
            visualize.plot_heatmap_montage(output_dir, thresholds)
            visualize.write_sweep_metrics(metrics,
                                          output_dir / "sweep_metrics.tsv")

    print("Introgressions analysis complete.")


def main(args):
    """The ``intros`` command: a config path, or a sub-tool name (heatmap |
    bed2txt | simulate) followed by its arguments."""
    target = args.target
    extra = [a for a in (args.extra or []) if a != "--"]
    # argparse.REMAINDER swallows flags placed after the positional target,
    # so `intros config.yaml --sweep` is accepted as well
    sweep = getattr(args, "sweep", False) or "--sweep" in extra
    extra = [a for a in extra if a != "--sweep"]

    if target == "heatmap":
        from . import heatmap

        heatmap.main(extra)
    elif target == "bed2txt":
        from . import bed2txt

        bed2txt.main(extra)
    elif target == "simulate":
        from . import simulate

        simulate.main(extra)
    else:
        cfg = parse_config(target)
        run_introgression_pipeline(cfg, sweep=sweep)
