#!/bin/bash
# The manual stage-by-stage pipeline of panagram_tpu's scripts/preprocess.sh
# on the port:
#
#   stage 1  --prepare        parse samples.tsv, write config.yaml
#   stage 2  index            per-sample distinct-kmer sets, the merged
#                             dictionary and the anchors (resumable)
#   stage 3  annotate         (re)ingest GFF gene/annotation tables
#
# Usage: panagram_tpu_torch/scripts/preprocess.sh <samples.tsv> <k> <outdir>
#            [cores] [device]
# device (default cuda) is passed as --device to index and annotate.
set -euo pipefail

input=$1
k=$2
outdir=$3
cores=${4:-1}
device=${5:-cuda}

# stage 1: initialize the index directory (no counting yet)
python -m panagram_tpu_torch index "$input" -o "$outdir" -k "$k" --prepare \
    --device "$device"

# stage 2: full build, resuming from whatever stage 1 left on disk; the
# per-stage wall-clock lands in $outdir/logs/*.benchmark.txt
python -m panagram_tpu_torch index "$outdir" -c "$cores" --device "$device"

# stage 3: refresh annotations for every sample that declares a GFF.
# Columns are located by header, and relative GFF paths resolve against
# the samples.tsv directory, as the indexer resolves them.
tsv_dir=$(cd "$(dirname "$input")" && pwd)
name_col=$(head -1 "$input" | tr '\t' '\n' | grep -nx name | cut -d: -f1 || true)
gff_col=$(head -1 "$input" | tr '\t' '\n' | grep -nx gff | cut -d: -f1 || true)
if [ -n "$gff_col" ]; then
    tail -n +2 "$input" | while IFS= read -r row; do
        name=$(printf '%s\n' "$row" | cut -f"$name_col")
        gff=$(printf '%s\n' "$row" | cut -f"$gff_col")
        [ -n "$gff" ] || continue
        case "$gff" in /*) ;; *) gff="$tsv_dir/$gff" ;; esac
        if [ -e "$gff" ]; then
            python -m panagram_tpu_torch annotate "$outdir" "$name" "$gff" \
                --device "$device"
        else
            echo "preprocess: WARNING gff not found for $name: $gff" >&2
        fi
    done
fi

echo "preprocess: index ready at $outdir"
