"""The plain reference against hand-worked cases."""

import torch

from portbench.reference import kmers as ref


def t(xs, dtype=torch.uint8):
    return torch.tensor(xs, dtype=dtype)


def test_kmer_words_forward_and_canonical():
    # ACGT at k = 2: AC = 0b0001, CG = 0b0110, GT = 0b1011; reverse
    # complements GT, CG, AC
    codes = t([0, 1, 2, 3])
    fwd, valid = ref.kmer_words(codes, 2, canonical=False)
    assert fwd.tolist() == [1, 6, 11] and valid.all()
    can, _ = ref.kmer_words(codes, 2)
    assert can.tolist() == [1, 6, 1]
    # k = 3, first base most significant: AAC = 1, its reverse complement
    # GTT = 0b101111 = 47
    can, _ = ref.kmer_words(t([0, 0, 1]), 3)
    assert can.tolist() == [1]
    can, _ = ref.kmer_words(t([2, 3, 3]), 3)
    assert can.tolist() == [1]


def test_n_windows_are_invalid():
    codes = t([0, 1, 4, 2, 3, 255, 0, 0])
    _, valid = ref.kmer_words(codes, 2)
    assert valid.tolist() == [True, False, False, True, False, False, True]
    assert ref.kmer_set(codes, 2).tolist() == [0, 1]


def test_kmer_set_short_sequence():
    assert ref.kmer_set(t([0, 1]), 3).numel() == 0


def test_masks_bit_order():
    keys = torch.tensor([5, 7, 9], dtype=torch.int64)
    sets = [torch.zeros(0, dtype=torch.int64) for _ in range(34)]
    sets[0] = torch.tensor([5], dtype=torch.int64)
    sets[31] = torch.tensor([5, 9], dtype=torch.int64)
    sets[33] = torch.tensor([7], dtype=torch.int64)
    m = ref.masks(keys, sets)
    assert m.dtype == torch.int32 and m.shape == (3, 2)
    assert m[0].tolist() == [1 - 2**31, 0]        # bits 0 and 31 of word 0
    assert m[1].tolist() == [0, 2]                # genome 33: word 1, bit 1
    assert m[2].tolist() == [-2**31, 0]
    # an order puts set order[g] in column g
    m2 = ref.masks(keys, sets, order=[33, 0])
    assert m2.shape == (3, 1) and m2[:, 0].tolist() == [2, 1, 0]


def test_rows_bytes_popcount_colsums():
    keys = torch.tensor([3, 8], dtype=torch.int64)
    mask = torch.tensor([[0x04030201, 0x0], [-1, 0x1]], dtype=torch.int32)
    words = torch.tensor([8, 3, 5, 3], dtype=torch.int64)
    valid = torch.tensor([True, True, True, False])
    r = ref.rows(words, valid, keys, mask)
    assert r.tolist() == [[-1, 1], [0x04030201, 0], [0, 0], [0, 0]]
    by = ref.row_bytes(r)
    assert by.dtype == torch.uint8 and by.shape == (4, 8)
    assert by[1].tolist() == [1, 2, 3, 4, 0, 0, 0, 0]
    assert by[0].tolist() == [255, 255, 255, 255, 1, 0, 0, 0]
    assert ref.popcount(by).tolist() == [33, 5, 0, 0]
    cs = ref.column_sums(r, 34)
    assert cs.dtype == torch.int64
    assert cs[0] == 2 and cs[1] == 1 and cs[2] == 1 and cs[3] == 1
    assert cs[31] == 1 and cs[32] == 1 and cs[33] == 0


def test_rows_of_an_empty_dictionary():
    r = ref.rows(torch.tensor([1, 2]), torch.tensor([True, True]),
                 torch.zeros(0, dtype=torch.int64),
                 torch.zeros(0, 2, dtype=torch.int32))
    assert r.shape == (2, 2) and not r.any()
