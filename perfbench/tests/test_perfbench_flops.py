"""The yardstick's counts, from shapes, at known values."""

import numpy as np
import pytest

from perfbench import flops


def test_k1_bound_counts_4_b_h_t2_d_at_the_bf16_peak():
    # (16, 1025, 64): 4 * 16 * 1025^2 * 64 = 4.3033e9 operations
    assert flops.k1_seconds(1, 16, 1025, 64) == pytest.approx(4 * 16 * 1025 ** 2 * 64 / 989e12)
    assert flops.k1_seconds(1, 16, 1025, 64) * 1e3 == pytest.approx(0.0043514, rel=1e-4)
    assert flops.k1_seconds(8, 16, 4097, 64) == pytest.approx(8 * flops.k1_seconds(1, 16, 4097, 64))


def test_vote_levels_follow_the_pyramid():
    # 50,000 pairs, 4 levels: two coarse of 6,250 pairs x 16, two fine of 50,000 x 8
    assert flops.vote_levels(50000, 4, 8) == [(6250, 16, False), (6250, 16, True),
                                              (50000, 8, True), (50000, 8, True)]
    assert flops.vote_levels(2000, 4, 8)[0] == (2000, 16, False)


def test_k2_bound_is_the_larger_of_operations_and_bytes():
    # a fine level at 2 rows: 2 * 50,000 * 8 * 37 = 29.6 M operations -> 0.442 us;
    # 2 * (50,000 * 49 + 16,384) bytes = 4.93 MB -> 1.47 us: bytes bound
    t = flops.k2_seconds(2, 50000, 8, True)
    assert t == pytest.approx(2 * (50000 * 49 + 4096 * 4) / 3.35e12)
    assert 2 * 50000 * 8 * 37 / 67e12 < t
    # many samples a pair make it operation bound
    assert flops.k2_seconds(1, 1000, 4096, True) == pytest.approx(1000 * 4096 * 37 / 67e12)


def test_vit_flops_per_block():
    # ViT-L/14 at stride 8 on a 256 crop: T = 1025, d = 1024, 24 blocks
    per_block = 24 * 1025 * 1024 ** 2 + 4 * 1025 ** 2 * 1024
    assert flops.vit_flops(1025, 1024, 24) == pytest.approx(24 * per_block)
    assert flops.vit_flops(1025, 1024, 24) / 1e12 == pytest.approx(0.7229, rel=1e-3)


def test_branch_flops_from_the_trees_widths():
    k = lambda a, b: {"kernel": np.zeros((a, b), np.float32), "bias": np.zeros(b, np.float32)}
    shot = {"params": {"shot_encoder": {"res0": {"fc1": k(352, 128)}},
                       "tuple_encoder": {"res0": {"fc1": k(50, 128)}}}}
    dino = {"params": {"desc_transform": k(1024, 256), "desc_pair_transform": k(1280, 256)}}
    got = flops.branch_flops(shot, dino, points=100, tuples=10)
    want = 2 * (100 * 352 * 128 + 10 * 50 * 128 + 100 * 1024 * 256 + 10 * 1280 * 256)
    assert got == want
