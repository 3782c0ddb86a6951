"""One mesh over two processes: ``index --mesh 4 --num-processes 2
--coordinator`` with two Gloo ranks in each process (the port's twin of
tests/test_multihost.py), against panagram_tpu's one-process build.

Process 1 writes under '<prefix>.p1'.  By default each process writes its
ranks' bitmap rows as BGZF pieces and process 0 stitches them, so the
bitmaps are compared decompressed (their blocks end elsewhere); every other
file exactly, as tests/test_torch_index.py compares (anno_types.txt as a
set)."""

import os
import subprocess
import sys

from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.io.bgzf import decompress_file
from panagram_tpu_torch.parallel.mesh import free_port
from tests.conftest import random_seq
from tests.test_torch_index import REPO, assert_same_file

K = 13
TIMEOUT = 300
TABLES = ("total_paircounts.csv", "bitsum.bins.tsv", "chrs.tsv",
          "bitsum.genes.tsv", "anno_types.txt", "gene.bed.gz")


def _write_pangenome(rng, tmp_path):
    fa_dir = tmp_path / "fa"
    fa_dir.mkdir()
    names = ["g1", "g2", "g3", "g4"]
    for n in names:
        seq = random_seq(rng, 2000, n_frac=0.005)
        (fa_dir / f"{n}.fa").write_text(f">chr1\n{seq}\n")
    gff = fa_dir / "g1.gff3"
    gff.write_text(
        "##gff-version 3\n"
        "chr1\tsrc\tgene\t101\t400\t.\t+\t.\tID=gene1;Name=GeneA\n"
        "chr1\tsrc\tgene\t901\t1500\t.\t-\t.\tID=gene2;Name=GeneB\n")
    samples = tmp_path / "samples.tsv"
    samples.write_text(
        "name\tfasta\tgff\n" + f"g1\t{fa_dir}/g1.fa\t{gff}\n"
        + "\n".join(f"{n}\t{fa_dir}/{n}.fa\t" for n in names[1:]) + "\n")
    return names, samples


def _run_mesh_2proc(samples, mesh_dir, env, expect_ok=True):
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "panagram_tpu_torch", "index", str(samples),
         "-o", str(mesh_dir), "-k", str(K), "--device", "cpu", "--mesh", "4",
         "--num-processes", "2", "--process-id", str(pid),
         "--coordinator", f"127.0.0.1:{port}"],
        env=env, stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    rcs = [p.returncode for p in procs]
    if expect_ok:
        assert rcs == [0, 0], [e[-3000:] for e in errs]
    return rcs, errs


def test_two_process_mesh_build_matches_single(rng, tmp_path):
    names, samples = _write_pangenome(rng, tmp_path)
    ref_dir = tmp_path / "single"
    jax_build_index(str(samples), prefix=str(ref_dir), k=K)

    # 256-position chunks: every chunk spans the 4 ranks (64 positions
    # each), so both processes own rows of every chunk
    env = dict(os.environ, PYTHONPATH=REPO, PANAGRAM_TPU_CHUNK_LOG2="8")
    env.pop("PANAGRAM_TPU_SHARD_WRITES", None)
    mesh_dir = tmp_path / "mesh2p"
    _run_mesh_2proc(samples, mesh_dir, env)

    mirror = tmp_path / "mesh2p.p1"
    for n in names:
        for step in (1, 100):
            want = decompress_file(
                str(ref_dir / "anchor" / n / f"bitmap.{step}.gz"))
            got = decompress_file(
                str(mesh_dir / "anchor" / n / f"bitmap.{step}.gz"))
            assert got == want, (n, step)
            # the stitched bitmap lives only under process 0's prefix
            assert not (mirror / "anchor" / n / f"bitmap.{step}.gz").exists()
        assert not list((mesh_dir / "anchor" / n).glob(".bitmap.*.part*"))
        assert not list((mirror / "anchor" / n).glob(".bitmap.*.part*"))
        for f in TABLES[:3]:
            assert_same_file(str(mesh_dir / "anchor" / n / f),
                             str(ref_dir / "anchor" / n / f))
            assert_same_file(str(mirror / "anchor" / n / f),
                             str(ref_dir / "anchor" / n / f))
    for f in TABLES[3:]:
        assert_same_file(str(mesh_dir / "anchor" / "g1" / f),
                         str(ref_dir / "anchor" / "g1" / f))
        assert_same_file(str(mirror / "anchor" / "g1" / f),
                         str(ref_dir / "anchor" / "g1" / f))
    assert_same_file(str(mesh_dir / "genome_dist.tsv"),
                     str(ref_dir / "genome_dist.tsv"))
    assert_same_file(str(mirror / "genome_dist.tsv"),
                     str(ref_dir / "genome_dist.tsv"))

    # a rerun over the same dirs skips every stage on every rank
    stamp = mesh_dir / "anchor" / names[0] / "bitmap.1.gz"
    before = stamp.stat().st_mtime
    _run_mesh_2proc(samples, mesh_dir, env)
    assert stamp.stat().st_mtime == before

    # the stitched .gzi serves random access to panagram_tpu's reader
    idx = JaxIndex(str(mesh_dir))
    ref = JaxIndex(str(ref_dir))
    assert idx.query_bitmap(names[0], "chr1", 100, 200, 1).equals(
        ref.query_bitmap(names[0], "chr1", 100, 200, 1))
    idx.close()
    ref.close()

    # opt-out: every process writes every file under its own prefix
    env0 = dict(env, PANAGRAM_TPU_SHARD_WRITES="0")
    mesh_dir0 = tmp_path / "mesh2p_mirror"
    _run_mesh_2proc(samples, mesh_dir0, env0)
    for n in names:
        want = (ref_dir / "anchor" / n / "bitmap.1.gz").read_bytes()
        assert (mesh_dir0 / "anchor" / n / "bitmap.1.gz").read_bytes() == want
        assert (tmp_path / "mesh2p_mirror.p1" / "anchor" / n
                / "bitmap.1.gz").read_bytes() == want

    # a stage that one process would skip and the other run fails loudly
    (mesh_dir / "kmc" / "pandict.npz").unlink()
    rcs, errs = _run_mesh_2proc(samples, mesh_dir, env, expect_ok=False)
    assert any(rc != 0 for rc in rcs)
    assert any("desync at 'dict-cache'" in e for e in errs), errs[0][-3000:]


def test_mesh_num_processes_requires_coordinator(tmp_path):
    from panagram_tpu_torch.__main__ import main

    samples = tmp_path / "samples.tsv"
    samples.write_text("name\tfasta\n")
    try:
        main(["index", str(samples), "-o", str(tmp_path / "x"),
              "--mesh", "8", "--num-processes", "2"])
    except SystemExit as e:
        assert "coordinator" in str(e)
    else:
        raise AssertionError("expected SystemExit")
