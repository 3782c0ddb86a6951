"""The port's index build against panagram_tpu's with 40 genomes: two mask
words per key and 5 bitmap bytes per position.  Byte-for-byte comparison
of every output file (tolerance 0), on the CPU."""

import numpy as np
import torch

from panagram_tpu.index import Index as JaxIndex
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch.pipeline import build_index
from tests.conftest import random_seq
from tests.test_torch_index import assert_same_tree

torch.set_num_threads(2)

K = 11


def test_many_genomes_multiword_outputs_byte_identical(tmp_path):
    rng = np.random.default_rng(40)
    base = random_seq(rng, 1200)
    fa_dir = tmp_path / "fa"
    fa_dir.mkdir()
    names = []
    for g in range(40):
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
    anchors = ["g00", "g07", "g39"]

    jax_build_index(str(samples), prefix=str(tmp_path / "jax"), k=K,
                    anchor_genomes=anchors)
    build_index(str(samples), prefix=str(tmp_path / "port"), k=K,
                anchor_genomes=anchors, device="cpu")
    n = assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert n == 3 + 41 + 7 * len(anchors)
    assert not (tmp_path / "port" / "anchor" / "g05").exists()

    pan = np.load(tmp_path / "port" / "kmc" / "pandict.npz")
    assert pan["masks"].shape[1] == 2
    idx = JaxIndex(str(tmp_path / "port"))
    df = idx.query_bitmap("g07", "chr1", 280, 330)
    assert df.shape == (50, 40)
    assert not df.to_numpy()[300 - K + 1 - 280:310 - 280].any()  # N windows
    idx.close()
