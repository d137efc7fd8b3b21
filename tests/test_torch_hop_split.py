"""The mirror of the ring-hop kernels' per-rank split
(``coll/cuda_kernels.py:hop_split``, ``split_of`` in
``csrc/ring_hop.cu``) against a brute-force split, over every pair of
source and destination residues modulo 16."""

import pytest

from ompi_tpu_torch.coll import cuda_kernels as ck

LENGTHS = tuple(range(0, 49)) + (4095, 4096, 4097, 4100, 1 << 20, (1 << 20) + 3)


def brute_split(src: int, dst: int, nbytes: int) -> tuple[int, int, int]:
    """The widest word w of 16, 8, 4, 2, 1 for which some head h < w
    puts both ends on multiples of w; the least such h (all the bytes
    when the range is shorter); the whole words; what is left."""
    for w in (16, 8, 4, 2, 1):
        heads = [h for h in range(w) if (src + h) % w == 0 and (dst + h) % w == 0]
        if heads:
            head = min(heads[0], nbytes)
            body = (nbytes - head) // w * w
            return head, w, nbytes - head - body
    raise AssertionError("w = 1 always splits")


@pytest.mark.parametrize("src_res", range(16))
def test_hop_split_matches_brute_force(src_res):
    for dst_res in range(16):
        for base in (0, 1 << 12, (1 << 40) + 256):
            src, dst = base + src_res, base + 512 + dst_res
            for nbytes in LENGTHS:
                head, w, tail = ck.hop_split(src, dst, nbytes)
                assert (head, w, tail) == brute_split(src, dst, nbytes), (src, dst, nbytes)
                assert head < w and tail < w and (nbytes - head - tail) % w == 0
                if nbytes - head - tail:  # the body's ends sit on words
                    assert (src + head) % w == 0 and (dst + head) % w == 0
                assert w == ck.put_word_bytes(src, dst)


@pytest.mark.parametrize("dtype_bytes", [2, 4, 8])
def test_fold_split_takes_all_three_ends(dtype_bytes):
    """The fold splits by all three ends: it takes 16-byte vectors only
    when both operands and the destination agree modulo 16, and every
    end is element-aligned, so its width is never below an element."""
    for a in range(0, 64, dtype_bytes):
        for b in range(0, 64, dtype_bytes):
            for d in range(0, 64, dtype_bytes):
                head, w, tail = ck.hop_split(a, b, 1000 * dtype_bytes, d)
                assert w >= dtype_bytes and head % dtype_bytes == 0 and tail % dtype_bytes == 0
                assert (w == 16) == ((a - b) % 16 == 0 and (a - d) % 16 == 0)
                assert w == min(ck.put_word_bytes(a, b), ck.put_word_bytes(a, d))
