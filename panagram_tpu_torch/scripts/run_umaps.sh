#!/bin/bash
# panagram_tpu's scripts/run_umaps.sh on the port: regenerate the
# bin-embedding CSVs of an anchor, render per-chromosome and whole-genome
# (ALL) embedding plots, then dump the pairwise shared-kmer percentages of
# every sample.  Its commands run on the host, so it takes no device.
#
# Usage: panagram_tpu_torch/scripts/run_umaps.sh <index_dir> <anchor> [out_dir]
set -euo pipefail

index_dir=$1
anchor=$2
out_dir=${3:-$index_dir/anchor/$anchor/umaps}

mkdir -p "$out_dir"

python -m panagram_tpu_torch.scripts.write_umaps "$index_dir" "$anchor"

# per-chromosome plots: chromosome names are column 1 of the anchor's
# chrs.tsv
tail -n +2 "$index_dir/anchor/$anchor/chrs.tsv" | cut -f1 | sort -u |
while read -r chrom; do
    echo "plotting $anchor/$chrom"
    python -m panagram_tpu_torch.scripts.plot_umaps "$index_dir" "$anchor" \
        "$chrom" --out "$out_dir"
done

echo "plotting $anchor/ALL"
python -m panagram_tpu_torch.scripts.plot_umaps "$index_dir" "$anchor" ALL \
    --out "$out_dir"

# pairwise shared-kmer fractions per sample
tail -n +2 "$index_dir/samples.tsv" | cut -f1 |
while read -r name; do
    python -m panagram_tpu_torch.scripts.pairwise_comp "$name" "$index_dir" \
        > "$index_dir/anchor/$name/perc_shared.$name.txt" || true
done
