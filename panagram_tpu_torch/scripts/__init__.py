"""The repo's user scripts (scripts/*.py, which drive panagram_tpu) on the
port, each runnable as ``python -m panagram_tpu_torch.scripts.<name>``
with the same positional arguments, printing what its twin prints:

query_index      gene, annotation, bitmap and k-mer pattern queries
make_bins_bits   unique / universal k-mer counts per bin
pairwise_comp    sampled per-genome shared k-mer totals of an anchor
pairwise_matrix  the exact genome x genome shared k-mer matrix (--device)
write_umaps      rewrites the anchors' bin-embedding CSVs
plot_umaps       embedding and PCA scatter PNGs (needs matplotlib)

Each has ``main(argv=None)`` for a call in process.
"""
