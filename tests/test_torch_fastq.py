"""FASTQ read sets in the port against panagram_tpu, on the CPU.

counted_kmers_chunked (k-mers seen at least min_count times across all
reads) must equal panagram_tpu.ops.count.counted_kmers_chunked exactly, at
4096-position chunks so that a few hundred reads cross chunk borders: reads
longer than a chunk, a read of exactly chunk + k - 1 bases, N bases, reads
shorter than k, and singleton error k-mers.  Inputs come from numpy with a
fixed seed; everything is integer (tolerance 0).
"""

import gzip

import numpy as np
import pytest
import torch

from panagram_tpu.ops.count import counted_kmers_chunked as jax_counted
from panagram_tpu.pipeline import _iter_fastq as jax_iter_fastq
from panagram_tpu_torch.io.fasta import seq_to_codes
from panagram_tpu_torch.ops import count
from panagram_tpu_torch.pipeline import _iter_fastq, build_index
from tests.conftest import random_seq

torch.set_num_threads(2)

CHUNK = 1 << 12


def read_set(rng, k):
    """Reads drawn from a 6-kbp genome at ~6x with 1% substitutions, plus
    the edge cases of the packing."""
    genome = random_seq(rng, 6000)
    reads = []
    for _ in range(240):
        n = int(rng.integers(20, 200))
        s = int(rng.integers(0, len(genome) - n))
        r = list(genome[s:s + n])
        for i in np.flatnonzero(rng.random(n) < 0.01):
            r[i] = "ACGT"[rng.integers(4)]
        reads.append("".join(r))
    reads += [
        genome[:CHUNK + k - 1],                  # exactly one full buffer
        genome[100:100 + CHUNK + k - 1],         # again: counts reach 2
        genome[:3 * CHUNK + 77],                 # longer than a chunk
        genome[7:7 + k - 1],                     # shorter than k
        genome[200:260] + "NNN" + genome[263:330],
        random_seq(rng, 90),                     # singleton k-mers
    ]
    order = rng.permutation(len(reads))
    return [reads[i] for i in order]


@pytest.mark.parametrize("k", [11, 21, 31])
def test_counted_kmers_chunked_matches_jax(k):
    rng = np.random.default_rng(k)
    reads = read_set(rng, k)
    for min_count in (1, 2, 3):
        want = jax_counted((seq_to_codes(r) for r in reads), k,
                           min_count=min_count, chunk=CHUNK)
        got = count.counted_kmers_chunked((seq_to_codes(r) for r in reads),
                                          k, "cpu", min_count=min_count,
                                          chunk=CHUNK)
        assert got.dtype == np.uint64
        assert np.array_equal(got, want), (k, min_count)
    assert len(got) > 0


def test_counted_kmers_merges_many_spills():
    """More counted chunks than SPILL_CHUNKS groups of SPILL_CHUNKS: the
    device merge and the host merge both run."""
    rng = np.random.default_rng(7)
    k = 11
    reads = [random_seq(rng, 150) for _ in range(900)]
    reads += reads[::3]
    got = count.counted_kmers_chunked((seq_to_codes(r) for r in reads), k,
                                      "cpu", chunk=1 << 10)
    want = jax_counted((seq_to_codes(r) for r in reads), k, chunk=1 << 10)
    assert np.array_equal(got, want)
    assert count.counted_kmers_chunked(iter([]), k).size == 0


@pytest.mark.parametrize("gz", [False, True])
def test_iter_fastq_matches_jax(tmp_path, gz):
    recs = "@a\nACGT\n+\nIIII\n@empty\n\n+\n\n@b desc\nNNACG  \n+\n!!!!!\n"
    path = tmp_path / ("r.fq.gz" if gz else "r.fastq")
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(recs)
    else:
        path.write_text(recs)
    assert list(_iter_fastq(str(path))) == list(jax_iter_fastq(str(path)))
    assert [s for _, s in _iter_fastq(str(path))] == ["ACGT", "NNACG"]


def test_device_dict_refuses_fastq(tmp_path):
    """--device-dict would read a FASTQ as FASTA and find nothing in it:
    the port raises a ValueError naming the read set."""
    rng = np.random.default_rng(3)
    (tmp_path / "a.fa").write_text(f">chr1\n{random_seq(rng, 500)}\n")
    (tmp_path / "r.fq").write_text("@r\nACGTACGTACGTAC\n+\nIIIIIIIIIIIIII\n")
    samples = tmp_path / "samples.tsv"
    samples.write_text(f"name\tfasta\nasm\t{tmp_path}/a.fa\n"
                       f"myreads\t{tmp_path}/r.fq\n")
    with pytest.raises(ValueError, match="myreads"):
        build_index(str(samples), prefix=str(tmp_path / "idx"), k=11,
                    device="cpu", device_dict=True)
