"""Operations, bytes and peaks: the yardstick of the roofline and MFU metrics.

Counts come from shapes and from the plain formula of each computation,
never from a kernel's own instruction stream, so a rewrite of a kernel
cannot move them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# the plain vote formula (`hist16.level_candidates` + `_quantize`) in float
# operations per (pair, sample): the candidate c + (cos t x0 + sin t y0) odist,
# 3 x (2 mul + 1 add + 1 mul + 1 add); the arc angle theta* + s span, cos and
# sin (4, fine levels only; level 0 reads a table); the quantization
# (c - lo) / cell + 0.5 and its floor, 3 x 4; the window test, 6 compares
VOTE_OPS_TABLE = 15 + 12 + 6
VOTE_OPS_ARC = VOTE_OPS_TABLE + 4
# per pair and row: c, x0, y0 (3 f32 each), odist (f32), ok (1 byte); the
# arc levels add theta* and span (f32 each)
PAIR_BYTES_TABLE = 4 * 10 + 1
PAIR_BYTES_ARC = PAIR_BYTES_TABLE + 8
HIST_BYTES = 16 ** 3 * 4     # one row's histogram written once


def k1_seconds(batch: int, heads: int, tokens: int, head_dim: int) -> float:
    """Least time of one attention call: 4 B h T^2 d operations (QK^T and PV)
    at the bf16 tensor peak."""
    return 4.0 * batch * heads * tokens * tokens * head_dim / PEAK_BF16_FLOPS


def vote_levels(pairs: int, levels: int, fine_samples: int, coarse_samples: int = 16):
    """(pairs, samples, arc) of each level of `vote_center`: the coarse levels
    (all but the last two) vote with an eighth of the pairs once there are
    8192 or more, 16 samples each; level 0 reads the shared angle table."""
    out = []
    for level in range(levels):
        coarse = level < levels - 2
        sub = pairs // 8 if coarse and pairs >= 8192 else pairs
        out.append((sub, coarse_samples if coarse else fine_samples, level > 0))
    return out


def k2_seconds(rows: int, pairs: int, samples: int, arc: bool) -> float:
    """Least time of one vote level over `rows` rows: the larger of its float
    operations at the f32 peak and its inputs read once plus its histograms
    written once at the HBM bandwidth."""
    ops = rows * pairs * samples * (VOTE_OPS_ARC if arc else VOTE_OPS_TABLE)
    nbytes = rows * (pairs * (PAIR_BYTES_ARC if arc else PAIR_BYTES_TABLE) + HIST_BYTES)
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def vit_flops(tokens: int, dim: int, depth: int) -> float:
    """Forward FLOPs of a ViT over one image: per block 24 T d^2 (qkv, proj
    and the 4x MLP) + 4 T^2 d (attention)."""
    return depth * (24.0 * tokens * dim * dim + 4.0 * tokens * tokens * dim)


def dense_flops(widths: Iterable[Tuple[int, int]], items: int) -> float:
    """2 d_in d_out FLOPs per item for each (d_in, d_out) linear."""
    return 2.0 * items * sum(a * b for a, b in widths)


def tree_linears(tree: Dict, prefix: str = "") -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) of every Dense kernel of a parameter tree, by path."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(tree_linears(v, path))
        elif k == "kernel" and len(getattr(v, "shape", ())) == 2:
            out[prefix] = (int(v.shape[0]), int(v.shape[1]))
    return out


def branch_flops(shot: Dict, dino: Dict, points: int, tuples: int) -> float:
    """Forward FLOPs of both branch MLPs for one instance, from the widths of
    their trees: the per-point encoders over `points` (SHOT's
    `shot_encoder`, the visual `desc_transform`), everything else once per
    tuple."""
    total = 0.0
    for tree, per_point in ((shot, "shot_encoder"), (dino, "desc_transform")):
        for path, wd in tree_linears(tree.get("params", tree)).items():
            total += dense_flops([wd], points if path.startswith(per_point) else tuples)
    return total
