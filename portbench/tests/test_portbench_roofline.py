"""The least-bytes count of an anchor chunk, worked by hand."""

from portbench.roofline import (PEAK_BYTES_PER_S, anchor_chunk_least_bytes,
                                count_bytes)


def test_count_bytes():
    assert [count_bytes(n) for n in (0, 1, 255, 256, 65535, 65536)] == [
        0, 1, 1, 2, 2, 3]


def test_tiny_chunk():
    # m = 10 positions at k = 3: 12 bases -> 3 bytes of 2-bit codes and 2
    # of validity bits; 7 distinct k-mers of 6 bits (1 byte each), 4 of
    # them in a dictionary of 40 genomes (5 bytes of presence): 7 + 20;
    # out: 10 x (5 bitmap bytes + a 1-byte popcount up to 40) and 40
    # column sums up to 10, a byte each: 60 + 40
    assert anchor_chunk_least_bytes(10, 3, 7, 4, 40) == 3 + 2 + 27 + 100


def test_full_chunk_at_k31_w1():
    m, k = 1 << 22, 31
    b = anchor_chunk_least_bytes(m, k, m, m, 30)
    bases = m + k - 1
    # 62-bit keys in 8 bytes, 4 presence bytes, a 1-byte popcount, column
    # sums up to 2^22 in 3 bytes
    assert b == (-(-bases // 4) + -(-bases // 8) + 8 * m + 4 * m
                 + m * (4 + 1) + 30 * 3)
    assert 0.021e-3 < b / PEAK_BYTES_PER_S < 0.023e-3   # about 22 us


def test_full_chunk_at_k21_w4():
    m, k = 1 << 21, 21
    b = anchor_chunk_least_bytes(m, k, m, m, 100)
    bases = m + k - 1
    # 42-bit keys in 6 bytes, 13 presence bytes, a 1-byte popcount
    assert b == (-(-bases // 4) + -(-bases // 8) + 6 * m + 13 * m
                 + m * (13 + 1) + 100 * 3)
