"""The plain reference: the pan-genome index's semantics in plain torch.

It imports torch alone, nothing of the program, and takes nothing the
program made: the genomes' codes in, the presence answers out.
"""
