"""The port's file-coordinated build (``index --num-processes 2`` without
--mesh, parallel/distributed.py) against panagram_tpu's one-process build:
two processes over one shared directory, no collective.  Every file equals
panagram_tpu's (assert_same_trees of tests/test_torch_index.py: exact, but
anno_types.txt as a set and UMAP coordinates within 1e-9)."""

import os
import subprocess
import sys

from panagram_tpu.pipeline import build_index as jax_build_index
from tests.conftest import random_seq
from tests.test_torch_index import REPO, assert_same_trees

K = 13
TIMEOUT = 300


def test_two_process_build_matches_single(rng, tmp_path):
    fa_dir = tmp_path / "fa"
    fa_dir.mkdir()
    names = ["g1", "g2", "g3", "g4"]
    for n in names:
        (fa_dir / f"{n}.fa").write_text(
            f">chr1\n{random_seq(rng, 2000, n_frac=0.005)}\n")
    samples = tmp_path / "samples.tsv"
    samples.write_text("name\tfasta\n" + "\n".join(
        f"{n}\t{fa_dir}/{n}.fa" for n in names) + "\n")

    jax_build_index(str(samples), prefix=str(tmp_path / "jax"), k=K)

    env = dict(os.environ, PYTHONPATH=REPO)
    dist_dir = tmp_path / "dist"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "panagram_tpu_torch", "index", str(samples),
         "-o", str(dist_dir), "-k", str(K), "--device", "cpu",
         "--num-processes", "2", "--process-id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], \
        [o[1][-2000:] for o in outs]
    assert "Index built at" in outs[0][0]
    assert "Process 1 finished its shard" in outs[1][0]
    assert sorted(os.listdir(dist_dir / "logs"))[:4] == [
        ".done.anchor.0", ".done.anchor.1", ".done.count.0", ".done.count.1"]
    # bitmaps, .gzi, tables, k-mer sets, the dictionary and the distances
    assert assert_same_trees(dist_dir, tmp_path / "jax") == 3 + 4 + 1 + 4 * 9
