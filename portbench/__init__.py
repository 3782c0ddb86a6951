"""The benchmark of panagram_tpu_torch on one CUDA card.

    python3 -m portbench.run --workload <config>.<mix> --seed N \
        --seconds S --trace 0|1

A cell of BENCHMARK.json is a deployment (``configs/<config>.json``) under
a traffic mix (``traffic/<mix>.json``).  The mix names its kind
(``kinds/<kind>.py``: anchor or build), the configuration its genome
generator (``genomes/<generator>.py``) and its dictionary builder
(``builders/<builder>.py``); every metric is read by
``metrics/<metric>.py``.  The harness finds each by the name it is given,
so a new cell, mix or metric is a new file.

The yardstick lives here and not in the program: the genome generators
(frozen copies), the plain reference (``reference/``), the least-bytes
arithmetic and the card's peaks (``roofline.py``), the trace reduction
(``trace.py``) and the comparison that decides ``correct``.  From the
program (``panagram_tpu_torch``) the harness takes the system under test
and its own phase timers; nothing here imports jax or panagram_tpu.
"""
