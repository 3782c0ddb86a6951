"""The port's index build against panagram_tpu's with several mask words
per key: 40 genomes (W=2, 5 bitmap bytes per position), 70 (W=3, 9 B) and
100 (W=4, 13 B, the repo's 100-genome scale row), on the default route and
on --device-dict.  Byte-for-byte comparison of every output file
(tolerance 0), on the CPU."""

import functools

import numpy as np
import pytest
import torch

from panagram_tpu import pipeline as jax_pipeline
from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.ops.count import distinct_kmers_chunked
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.__main__ import main as port_main
from panagram_tpu_torch.pipeline import build_index
from tests.conftest import random_seq
from tests.test_torch_index import (
    assert_same_tree,
    assert_same_trees,
    jax_build_device_dict,
)

torch.set_num_threads(2)

K = 11
GENOMES = (40, 70, 100)


def anchors(ngenomes):
    return ["g00", "g07", f"g{ngenomes - 1}"]


@pytest.fixture(scope="module", params=GENOMES)
def samples(request, tmp_path_factory):
    """N genomes of 1200 bp: one base with 5 + g point changes each, and
    an N run in g07."""
    ngenomes = request.param
    tmp_path = tmp_path_factory.mktemp(f"multiword{ngenomes}")
    rng = np.random.default_rng(ngenomes)
    base = random_seq(rng, 1200)
    fa_dir = tmp_path / "fa"
    fa_dir.mkdir()
    names = []
    for g in range(ngenomes):
        s = list(base)
        for i in rng.choice(len(s), 5 + g, replace=False):
            s[i] = "ACGT"[rng.integers(4)]
        if g == 7:
            s[300:310] = "N" * 10
        name = f"g{g:02d}"
        (fa_dir / f"{name}.fa").write_text(f">chr1\n{''.join(s)}\n")
        names.append(name)
    samples = tmp_path / "samples.tsv"
    samples.write_text("name\tfasta\n" + "".join(
        f"{n}\t{fa_dir}/{n}.fa\n" for n in names))
    return samples


def _shape(samples):
    """(genomes, mask words) of a samples fixture."""
    ngenomes = len(samples.read_text().splitlines()) - 1
    return ngenomes, (ngenomes + 31) // 32


def test_many_genomes_multiword_outputs_byte_identical(samples, monkeypatch):
    tmp_path = samples.parent
    ngenomes, W = _shape(samples)
    names = anchors(ngenomes)
    # panagram_tpu counts each genome in chunks of 2^22 positions, most of
    # a second each on the CPU; one chunk of 2^12 holds a genome here and
    # gives the same set
    monkeypatch.setattr(jax_pipeline, "distinct_kmers_chunked",
                        functools.partial(distinct_kmers_chunked,
                                          chunk=1 << 12))
    jax_build_index(str(samples), prefix=str(tmp_path / "jax"), k=K,
                    anchor_genomes=names)
    build_index(str(samples), prefix=str(tmp_path / "port"), k=K,
                anchor_genomes=names, device="cpu")
    n = assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert n == 3 + ngenomes + 1 + 9 * len(names)
    assert not (tmp_path / "port" / "anchor" / "g05").exists()

    pan = np.load(tmp_path / "port" / "kmc" / "pandict.npz")
    assert pan["masks"].shape[1] == W
    idx = JaxIndex(str(tmp_path / "port"))
    df = idx.query_bitmap("g07", "chr1", 280, 330)
    assert df.shape == (50, ngenomes)
    assert not df.to_numpy()[300 - K + 1 - 280:310 - 280].any()  # N windows
    idx.close()


def test_many_genomes_device_dict_byte_identical(samples):
    tmp_path = samples.parent
    ngenomes, W = _shape(samples)
    names = anchors(ngenomes)
    jax_build_device_dict(samples, tmp_path / "jax_dd", k=K,
                          anchor_genomes=names)
    port_main(["index", str(samples), "-k", str(K), "--prefix",
               str(tmp_path / "port_dd"), "--device", "cpu", "--device-dict",
               "--anchor-genomes", *names])
    n = assert_same_trees(tmp_path / "port_dd", tmp_path / "jax_dd")
    assert n == 3 + 1 + 9 * len(names)
    pan = np.load(tmp_path / "port_dd" / "kmc" / "pandict.npz")
    assert pan["masks"].shape[1] == W and str(pan["key_space"]) == "mixed"
