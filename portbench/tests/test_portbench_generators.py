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



def test_founder_chromosomes_lengths_and_draw_order():
    """Each chromosome its length, the same genomes at the same seed, and
    the stated draw order: the founder model chromosome after chromosome
    from one generator."""
    from portbench.genomes import founder_chromosomes

    cfg = {"genomes": 5, "chromosome_bp": [1500, 900, 1200], "founders": 4,
           "founder_divergence": 0.01, "private_variation": 0.001}
    got = founder_chromosomes.make(cfg, np.random.default_rng(3))
    again = founder_chromosomes.make(cfg, np.random.default_rng(3))
    rng = np.random.default_rng(3)
    want = [list(founder.founder_genomes(5, bp, rng))
            for bp in cfg["chromosome_bp"]]
    assert len(got) == 5
    for g, chrs in enumerate(got):
        assert [len(c) for c in chrs] == cfg["chromosome_bp"]
        for h, c in enumerate(chrs):
            assert c.dtype == np.uint8 and c.max() < 4
            assert c.tobytes() == again[g][h].tobytes()
            assert c.tobytes() == want[h][g].tobytes()
    other = founder_chromosomes.make(cfg, np.random.default_rng(4))
    assert other[0][0].tobytes() != got[0][0].tobytes()


def test_founder_chromosomes_refuses_other_parameters():
    import pytest

    from portbench.genomes import founder_chromosomes

    cfg = {"genomes": 2, "chromosome_bp": [1000, 500], "founders": 3,
           "founder_divergence": 0.01, "private_variation": 0.001}
    with pytest.raises(ValueError):
        founder_chromosomes.make(cfg, np.random.default_rng(0))
