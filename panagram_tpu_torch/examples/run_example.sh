#!/bin/bash
# End-to-end example on the port: simulate a pan-genome with
# introgressions, index it, render similarity heatmaps, call and score
# introgressions.  panagram_tpu's examples/run_example.sh with
# python -m panagram_tpu_torch in place of the JAX package.
# Usage:  bash panagram_tpu_torch/examples/run_example.sh [workdir] [device]
# device (default cuda) is passed as --device to the index build.

set -e
cd "$(dirname "$0")/../.."
WORK=${1:-${TMPDIR:-/tmp}/panagram_tpu_torch_example}
DEVICE=${2:-cuda}
export PYTHONPATH="$(pwd):$PYTHONPATH"
rm -rf "$WORK"
mkdir -p "$WORK/FASTAS"

echo "Generating a toy reference..."
python - "$WORK" <<'EOF'
import sys

import numpy as np

work = sys.argv[1]
rng = np.random.default_rng(1)
seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 2_000_000)])
with open(f"{work}/FASTAS/toyref.fasta", "w") as f:
    f.write(">chr1\n")
    for i in range(0, len(seq), 70):
        f.write(seq[i : i + 70] + "\n")
EOF

echo "Simulating introgressions..."
python -m panagram_tpu_torch intros simulate \
  --ref "$WORK/FASTAS/toyref.fasta" \
  --out-folder "$WORK/simulated_data" \
  --num-introgressions 2 \
  --introgression-size-min 100000 \
  --introgression-size-max 250000 \
  --rel-sub-rate 0.02 \
  --mut-sub-rate 4e-4 --mut-ins-rate 1e-6 --mut-del-rate 1e-6 \
  --mut-rate-start 1e-4 \
  --rounds 3 --seed 7

cat > "$WORK/samples.tsv" <<EOF
name	fasta
Reference	FASTAS/toyref.fasta
WildRelative	simulated_data/toyref_wildrelative.fasta
OffspringGen1	simulated_data/toyref_0_offspring.fasta
OffspringGen2	simulated_data/toyref_1_offspring.fasta
OffspringGen3	simulated_data/toyref_2_offspring.fasta
OffspringGen4	simulated_data/toyref_3_offspring.fasta
EOF

cat > "$WORK/group.tsv" <<EOF
name	group
Reference	REF
WildRelative	WT
OffspringGen1	OFFSPRING
OffspringGen2	OFFSPRING
OffspringGen3	OFFSPRING
OffspringGen4	OFFSPRING
EOF

echo "Building the pan-kmer index (k=21)..."
(cd "$WORK" && python -m panagram_tpu_torch index samples.tsv -o . -k 21 \
  --device "$DEVICE")

echo "Rendering k-mer similarity heatmaps..."
for anchor in Reference OffspringGen1 OffspringGen2; do
  python -m panagram_tpu_torch intros heatmap \
    --index-dir "$WORK" --anchor "$anchor" --groups "$WORK/group.tsv" \
    --bin 10000
done

echo "Converting simulated ground truth for scoring..."
python -m panagram_tpu_torch intros bed2txt \
  --gt_bed_file "$WORK/simulated_data/toyref_0_introgressions.bed" \
  --index_dir "$WORK" \
  --ref Reference --wild_type WildRelative --wild_type_group WT \
  --bin_size 10000

cat > "$WORK/2way_config.yaml" <<EOF
general:
  output_dir: $WORK/introgressions/2way_calls
  index_dir: $WORK
  tsv: $WORK/group.tsv
  bin: 10000
  ref: Reference
  threads: 1
calling:
  run: true
  grp: [OFFSPRING]
  cmp: [REF]
  thr: [0.8]
  stp: 100
  trm: 3
  sft: mean
  ssz: 2
  urf: true
  rmf: true
  vis: true
postprocessing:
  run: true
  act: [fgap, rmbn]
  min: 2
  gap: 1
scoring:
  run: true
  gdt: $WORK/simulated_data
  thr: 0.25
  cmp: [WT]
  vis: true
  min: 1
  gap: 1
EOF

echo "Calling + scoring introgressions (2-way)..."
python -m panagram_tpu_torch intros "$WORK/2way_config.yaml"

echo
echo "Done! Outputs:"
echo "  index:        $WORK/{anchor,kmc,genome_dist.tsv}"
echo "  heatmaps:     $WORK/panagram_visuals/"
echo "  calls+scores: $WORK/introgressions/2way_calls/"
cat "$WORK"/introgressions/2way_calls/*_0.8/scored/metrics_*.tsv
echo "Browse with: python -m panagram_tpu_torch view $WORK"
