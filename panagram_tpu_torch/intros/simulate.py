"""Deterministic pan-genome introgression simulator (``intros simulate``).

A copy of panagram_tpu's generator, so that the port imports nothing of
that package: the same arguments and seed write the same FASTA and BED
bytes.  It mutates a reference into a "wild relative" (SNPs + skew-sized
indels with edge-biased placement), splices introgression segments from the
relative back into the reference to create generation-0 offspring, then
accumulates mutations over generations with linearly increasing rates,
tracking introgression coordinates through indels with a reverse coordinate
mapper.  Outputs (matching the reference's names consumed by
run_example.sh / samples.tsv):

  <base>_wildrelative.fasta
  <base>_{gen}_offspring.fasta
  <base>_{gen}_introgressions.bed
"""

from __future__ import annotations

import argparse
import gzip
from pathlib import Path

import numpy as np

BASES = np.array(list("ACGT"))


def parse_fasta(path):
    seqs = {}
    opn = gzip.open if str(path).endswith(".gz") else open
    name = None
    chunks = []
    with opn(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line[0] == ">":
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


def write_fasta(seqs, path, wrap=60):
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), wrap):
                f.write(seq[i : i + wrap] + "\n")


def write_bed(entries, path):
    with open(path, "w") as f:
        for e in entries:
            f.write(e + "\n")


def skewed_sizes(n, size_min, size_max, rng, a=0.05, b=1):
    """Beta(a, b)-skewed indel sizes: mostly small, occasionally large
    (the reference's size model, simulate_introgressions.py:215-235)."""
    if n == 0:
        return np.zeros(0, int)
    frac = rng.beta(a, b, size=n)
    return (size_min + frac * (size_max - size_min)).astype(int).clip(size_min, size_max)


def edge_biased_weights(length, rng, edge_fraction=0.3, edge_power=5):
    """Position weights boosted near chromosome ends (reference :266-298)."""
    x = np.linspace(0, 1, length)
    w = 1.0 + ((1 - np.minimum(x, 1 - x) / edge_fraction).clip(0) ** edge_power) * 4
    return w / w.sum()


def mutate_sequence(seq, sub_rate, ins_rate, del_rate, ins_size_min,
                    ins_size_max, del_size_min, del_size_max, rng):
    """Apply SNPs + indels; returns (new_seq, reverse_mapper) where
    reverse_mapper[old_pos] = new_pos or -1 if deleted (the bookkeeping of
    reference :393-507)."""
    n = len(seq)
    arr = np.frombuffer(seq.encode(), dtype="S1").astype("U1")

    n_sub = rng.poisson(sub_rate * n)
    n_ins = rng.poisson(ins_rate * n)
    n_del = rng.poisson(del_rate * n)

    weights = edge_biased_weights(n, rng)
    sub_pos = rng.choice(n, size=min(n_sub, n), replace=False, p=weights)
    for p in sub_pos:
        cur = arr[p]
        choices = [b for b in "ACGT" if b != cur]
        arr[p] = choices[rng.integers(3)]

    # indel events: position -> (+len insertion) or (-len deletion)
    events = {}
    ins_pos = rng.choice(n, size=min(n_ins, n), replace=False, p=weights)
    ins_len = skewed_sizes(len(ins_pos), ins_size_min, ins_size_max, rng)
    for p, l in zip(ins_pos, ins_len):
        events[int(p)] = ("ins", int(l))
    del_pos = rng.choice(n, size=min(n_del, n), replace=False, p=weights)
    del_len = skewed_sizes(len(del_pos), del_size_min, del_size_max, rng)
    for p, l in zip(del_pos, del_len):
        events.setdefault(int(p), ("del", int(l)))

    out = []
    mapper = np.full(n + 1, -1, dtype=np.int64)
    i = 0
    new_i = 0
    positions = sorted(events)
    pi = 0
    while i < n:
        if pi < len(positions) and positions[pi] == i:
            kind, l = events[positions[pi]]
            pi += 1
            if kind == "ins":
                ins = BASES[rng.integers(0, 4, l)]
                out.append("".join(ins))
                new_i += l
                mapper[i] = new_i
                out.append(str(arr[i]))
                new_i += 1
                i += 1
            else:
                # deletion of l bases starting here
                end = min(i + l, n)
                while pi < len(positions) and positions[pi] < end:
                    pi += 1
                i = end
        else:
            mapper[i] = new_i
            out.append(str(arr[i]))
            new_i += 1
            i += 1
    mapper[n] = new_i
    return "".join(out), mapper


def apply_genome_wide_mutations(seqs, sub_rate, ins_rate, del_rate,
                                ins_size_min, ins_size_max, del_size_min,
                                del_size_max, rng):
    out = {}
    mappers = {}
    for chrom, seq in seqs.items():
        new_seq, mapper = mutate_sequence(
            seq, sub_rate, ins_rate, del_rate, ins_size_min, ins_size_max,
            del_size_min, del_size_max, rng)
        out[chrom] = new_seq
        mappers[chrom] = mapper
    return out, mappers


def apply_genome_wide_introgressions(ref_seqs, rel_seqs, mappers,
                                     num_intros, size_min, size_max, rng):
    """Splice segments of the relative into the reference (reference
    :152-212); returns (offspring_seqs, bed_lines in REFERENCE coords)."""
    out = dict(ref_seqs)
    beds = []
    for chrom in ref_seqs:
        ref = out[chrom]
        mapper = mappers[chrom]
        n = len(ref)
        placed = []
        tries = 0
        while len(placed) < num_intros and tries < 1000:
            tries += 1
            size = int(rng.integers(size_min, size_max + 1))
            if size >= n:
                continue
            start = int(rng.integers(0, n - size))
            end = start + size
            if any(not (end <= s or start >= e) for s, e in placed):
                continue
            placed.append((start, end))
        placed.sort()
        # resolve each segment's (reference span, relative span) ONCE, so
        # the splice and the ground-truth BED use identical coordinates
        resolved = []
        for start, end in placed:
            while mapper[start] < 0 and start < end:
                start += 1
            while mapper[end] < 0 and end > start:
                end -= 1
            rs, re_ = mapper[start], mapper[end]
            if end <= start or re_ <= rs:
                continue
            resolved.append((start, end, int(rs), int(re_)))

        # splice from the end so earlier coordinates stay valid
        for start, end, rs, re_ in sorted(resolved, reverse=True):
            ref = ref[:start] + rel_seqs[chrom][rs:re_] + ref[end:]
        out[chrom] = ref

        # offspring-genome coordinates (segment lengths may differ from the
        # reference span they replaced)
        shift = 0
        for start, end, rs, re_ in resolved:
            seg_len = re_ - rs
            beds.append(
                f"{chrom}\t{start + shift}\t{start + shift + seg_len}\tintrogression")
            shift += seg_len - (end - start)
    return out, beds


def main(argv=None):
    p = argparse.ArgumentParser(description="Simulate pan-genome introgressions")
    p.add_argument("--ref", required=True)
    p.add_argument("--out-folder", required=True)
    p.add_argument("--num-introgressions", type=int, default=2)
    p.add_argument("--introgression-size-min", type=int, default=3_000_000)
    p.add_argument("--introgression-size-max", type=int, default=7_000_000)
    p.add_argument("--rounds", type=int, default=6,
                   help="offspring generations after generation 0")
    p.add_argument("--rel-sub-rate", type=float, default=3e-3)
    p.add_argument("--rel-ins-rate", type=float, default=1e-4)
    p.add_argument("--rel-del-rate", type=float, default=1e-4)
    p.add_argument("--rel-ins-size-min", type=int, default=1)
    p.add_argument("--rel-ins-size-max", type=int, default=1000)
    p.add_argument("--rel-del-size-min", type=int, default=1)
    p.add_argument("--rel-del-size-max", type=int, default=500)
    p.add_argument("--mut-sub-rate", type=float, default=1e-3)
    p.add_argument("--mut-ins-rate", type=float, default=5e-5)
    p.add_argument("--mut-del-rate", type=float, default=5e-5)
    p.add_argument("--mut-rate-start", type=float, default=3e-4)
    p.add_argument("--mut-ins-size-min", type=int, default=1)
    p.add_argument("--mut-ins-size-max", type=int, default=1000)
    p.add_argument("--mut-del-size-min", type=int, default=1)
    p.add_argument("--mut-del-size-max", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    out_dir = Path(args.out_folder)
    out_dir.mkdir(parents=True, exist_ok=True)

    reference = Path(args.ref)
    base = Path(reference.name.removesuffix(".gz")).stem
    ref_seqs = parse_fasta(reference)
    if not ref_seqs:
        raise ValueError(f"no sequences read from {reference}")

    rel_seqs, mappers = apply_genome_wide_mutations(
        ref_seqs, args.rel_sub_rate, args.rel_ins_rate, args.rel_del_rate,
        args.rel_ins_size_min, args.rel_ins_size_max,
        args.rel_del_size_min, args.rel_del_size_max, rng)
    write_fasta(rel_seqs, out_dir / f"{base}_wildrelative.fasta")

    offspring, introgressions = apply_genome_wide_introgressions(
        ref_seqs, rel_seqs, mappers,
        args.num_introgressions, args.introgression_size_min,
        args.introgression_size_max, rng)
    write_fasta(offspring, out_dir / f"{base}_0_offspring.fasta")
    write_bed(introgressions, out_dir / f"{base}_0_introgressions.bed")

    parent = offspring
    sub_rates = np.linspace(args.mut_rate_start, args.mut_sub_rate, args.rounds)
    ins_rates = np.linspace(args.mut_rate_start, args.mut_ins_rate, args.rounds)
    del_rates = np.linspace(args.mut_rate_start, args.mut_del_rate, args.rounds)

    chroms = [e.split("\t")[0] for e in introgressions]
    starts = [int(e.split("\t")[1]) for e in introgressions]
    ends = [int(e.split("\t")[2]) for e in introgressions]

    for i in range(args.rounds):
        offspring, mappers = apply_genome_wide_mutations(
            parent, sub_rates[i], ins_rates[i], del_rates[i],
            args.mut_ins_size_min, args.mut_ins_size_max,
            args.mut_del_size_min, args.mut_del_size_max, rng)
        new_beds = []
        for j in range(len(introgressions)):
            mapper = mappers[chroms[j]]
            s, e = starts[j], ends[j]
            while mapper[s] < 0 and s < e:
                s += 1
            while mapper[e] < 0 and e > s:
                e -= 1
            new_beds.append(
                f"{chroms[j]}\t{mapper[s]}\t{mapper[e]}\tintrogression")
            starts[j], ends[j] = int(mapper[s]), int(mapper[e])
        write_fasta(offspring, out_dir / f"{base}_{i+1}_offspring.fasta")
        write_bed(new_beds, out_dir / f"{base}_{i+1}_introgressions.bed")
        parent = offspring

    print("Simulation finished.")


if __name__ == "__main__":
    main()
