"""Host I/O: FASTA reading and BGZF writing."""
