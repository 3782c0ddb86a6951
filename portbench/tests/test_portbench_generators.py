"""The frozen generator copies give the program's genomes for the same
seed."""

import numpy as np

from portbench.genomes import founder


def test_founder_copy_is_byte_equal():
    from panagram_tpu_torch.tools.scale_run import founder_genomes

    want = list(founder_genomes(30, 1 << 14, np.random.default_rng(0)))
    got = list(founder.founder_genomes(30, 1 << 14, np.random.default_rng(0)))
    assert len(got) == 30
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.tobytes() == b.tobytes()


def test_founder_make_refuses_other_parameters():
    import pytest

    cfg = {"genomes": 2, "genome_bp": 1000, "founders": 4,
           "founder_divergence": 0.02, "private_variation": 0.001}
    with pytest.raises(ValueError):
        founder.make(cfg, np.random.default_rng(0))

