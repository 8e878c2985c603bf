"""The traffic generator: one seed, one frame set; another seed, other frames."""

import numpy as np
import pytest

from perfbench.scenes.generate import frame_set
from perfbench.scenes.render import tiers_of

MIX = {"frames": 2, "instances": [1, 2], "per_frame": "distinct", "categories": ["can", "mug"],
       "distance_m": [0.8, 1.0], "tiers": [256], "tierless_frames": 0, "tierless_categories": [],
       "min_pixels": 300}


@pytest.fixture(scope="module")
def frames():
    return frame_set(MIX, 2 ** 31 + 3, "cpu"), frame_set(MIX, 2 ** 31 + 3, "cpu"), frame_set(MIX, 4, "cpu")


def test_one_seed_gives_the_same_frames_and_masks(frames):
    a, b, _ = frames
    for fa, fb in zip(a, b):
        assert np.array_equal(fa.rgb, fb.rgb) and np.array_equal(fa.depth, fb.depth)
        assert [c for c, _ in fa.dets] == [c for c, _ in fb.dets]
        assert all(np.array_equal(ma, mb) for (_, ma), (_, mb) in zip(fa.dets, fb.dets))


def test_another_seed_gives_other_frames(frames):
    a, _, c = frames
    assert any(not np.array_equal(fa.depth, fc.depth) for fa, fc in zip(a, c))


def test_the_mix_fixes_the_work_and_the_masks_their_tiers(frames):
    for fs in frames:
        assert sorted(len(f.dets) for f in fs) == [1, 2]
        for f in fs:
            masks = [m for _, m in f.dets]
            assert tiers_of(masks) == [256] * len(masks)
            assert all(m.sum() >= MIX["min_pixels"] for m in masks)
            assert all(np.all(f.depth[m] > 0) for m in masks)
            ids = np.zeros(f.depth.shape, int)
            for i, m in enumerate(masks):
                assert not np.any(ids[m]), "masks overlap"
                ids[m] = i + 1
