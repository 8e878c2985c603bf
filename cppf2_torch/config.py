"""Category / pipeline configuration as plain dataclasses.

The port's own copy of the JAX package's `config.py` (CategoryConfig,
CATEGORIES, PipelineConfig): the two packages share no module, so the
configuration lives here too and must stay field-for-field identical
(tests/test_torch_core.py checks it). Training configuration is not part of
the inference slice and is not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CategoryConfig:
    """Static per-category configuration.

    Mirrors the information content of the reference's hydra config
    (config/config.yaml + config/category/<name>.yaml) but as a frozen dataclass
    used as a *static* argument to jitted functions.
    """

    name: str
    category_id: int                  # NOCS class id, 1..6
    res: float = 2e-3                 # voxel resolution in meters (config/config.yaml:1)
    up: Tuple[int, int, int] = (0, 1, 0)      # canonical up axis (config/config.yaml:11)
    right: Tuple[int, int, int] = (1, 0, 0)   # canonical right axis (config/config.yaml:12)
    front: Tuple[int, int, int] = (0, 0, 1)   # canonical front axis (config/config.yaml:13)
    num_more: int = 3                 # extra tuple points beyond the pair (config/config.yaml:14)
    up_sym: bool = False              # continuous rotational symmetry about `up`
    # metric scale range sampled during synthetic data generation
    # (reference: dataset.py:165-172 `shapenet_obj_scales`)
    scale_range: Tuple[float, float] = (0.1, 0.3)
    # per-category default for PipelineConfig.scale_mode (used when the
    # pipeline leaves it None). "head" for mug: when the handle is occluded,
    # canonical predictions collapse toward the body's ring marginal and the
    # reference's per-pair |obs|/|pred| rescale overshoots ~1.4x (a ~5 cm
    # systematic center bias, measured); the scale-head factor removes it
    # (hidden-handle 5°5cm 0.0 -> 0.5, visible frames unchanged).
    scale_mode: str = "pair"
    # per-category default for PipelineConfig.yaw_sweep: a post-alignment
    # yaw micro-sweep about the canonical up axis, rescored with pairs
    # weighted by their predicted canonical radial excess. For mug the yaw
    # signal lives almost entirely in the handle (~7% of the cloud) that
    # the alignment L1 barely feels — the measured round-2/3 residual is
    # visible-handle 5-7 deg yaw near-misses.
    yaw_sweep: bool = False

    @property
    def tuple_size(self) -> int:
        return self.num_more + 2

    @property
    def num_pairs_in_tuple(self) -> int:
        k = self.tuple_size
        return k * (k - 1) // 2

    @property
    def up_axis_index(self) -> int:
        return int(max(range(3), key=lambda i: abs(self.up[i])))

    @property
    def right_axis_index(self) -> int:
        return int(max(range(3), key=lambda i: abs(self.right[i])))


# NOCS REAL275 category registry (reference: dataset.py:29-37 for ids;
# config/category/*.yaml for axes/symmetry; dataset.py:165-172 for scale ranges).
CATEGORIES: Dict[str, CategoryConfig] = {
    "bottle": CategoryConfig("bottle", 1, up_sym=True, scale_range=(0.16, 0.25)),
    "bowl": CategoryConfig("bowl", 2, up_sym=True, scale_range=(0.1851, 0.26)),
    "camera": CategoryConfig(
        "camera", 3, front=(1, 0, 0), right=(0, 0, 1), scale_range=(0.1430, 0.28)
    ),
    "can": CategoryConfig("can", 4, up_sym=True, scale_range=(0.128, 0.18)),
    "laptop": CategoryConfig("laptop", 5, scale_range=(0.3862, 0.58)),
    "mug": CategoryConfig(
        "mug", 6, front=(1, 0, 0), right=(0, 0, 1),
        scale_range=(0.1501, 0.1995), scale_mode="head",
    ),
}

ID2CATEGORY: Dict[int, str] = {c.category_id: n for n, c in CATEGORIES.items()}
CATEGORY2ID: Dict[str, int] = {n: c.category_id for n, c in CATEGORIES.items()}

# NOCS synset names with background, indexed by class id (reference: eval.py:400-407).
SYNSET_NAMES = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]


def get_category(name_or_id) -> CategoryConfig:
    if isinstance(name_or_id, int):
        return CATEGORIES[ID2CATEGORY[name_or_id]]
    return CATEGORIES[name_or_id]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static shape/budget configuration for the jitted inference graph.

    The reference uses dynamic shapes (downsampled cloud size, masked pairs);
    TPU requires static ones. `n_points` / `num_pairs` are padded budgets with
    validity masks.
    """

    n_points: int = 8192          # padded point budget after voxel downsampling
    num_pairs: int = 50000        # tuple budget (reference: eval.py:58 num_pairs=50000)
    num_bins: int = 32            # canonical coordinate bins (reference: train_shot.py:67 64*3 -> (6,32))
    angle_tol_deg: float = 1.0    # sphere accumulator tolerance (reference: eval.py:55)
    backproj_ratio: float = 0.1   # kept fraction after backvoting (reference: eval.py:57)
    imp_wt_margin: float = 0.01   # importance weight margin (reference: eval.py:56)
    opt_steps: int = 100          # alignment optimizer iterations (reference: eval.py:327)
    opt_lr: float = 1e-2          # alignment Adam lr (reference: eval.py:325)
    neighbor_k: int = 48          # fixed neighbor budget for normals/SHOT
                                  # (all synthetic accuracy results use 48;
                                  # 64 costs ~1.3x preprocess for no measured
                                  # accuracy gain)
    vote_levels: int = 4          # center-vote pyramid depth (ops/voting.py
                                  # ::vote_center). The last two levels both
                                  # sit at the res floor for REAL275-scale
                                  # clouds; exposed so the 3-level variant
                                  # can be paired-validated (each full-power
                                  # fine level's histogram costs ~2.4 ms at
                                  # 50k pairs — scripts/hist_dtype_bench.py)
    vote_fine_samples: int = 8    # arc samples/pair at the full-power fine
                                  # levels (coarse levels stay at 16). 8 vs
                                  # the round-2 default 12 is paired-equal on
                                  # the same 50 camera frames (5°5cm 0.78 vs
                                  # 0.72, medians within +0.3°/+0.05 cm —
                                  # benchmarks/r5_votecfg_camera) and cuts
                                  # the pose graph's dominant cost, the
                                  # fine-level vote histograms, by a third
                                  # (~2.4 ms/600k samples, hist_dtype_bench)
    restarts: int = 1             # best-of-N ensemble restarts by recon loss
                                  # (inference-time scaling; 1 = reference path)
    scale_mode: Optional[str] = None  # canonical->metric rescale of predicted
                                  # pairs before voting; None = the category's
                                  # default (CategoryConfig.scale_mode):
                                  #  "pair"  — per-pair |obs|/|pred| length
                                  #    ratio (reference: eval.py:233-235);
                                  #  "head"  — one global factor, the scale
                                  #    head's median-bound max component (the
                                  #    bound.max() that normalizes the
                                  #    canonical frame);
                                  #  "split" — like "head", plus a per-pair xz
                                  #    factor solved so the rescaled pair
                                  #    length matches the observed length,
                                  #    feeding the translation targets only.
                                  # The per-pair ratio is biased ~1.4x high
                                  # when canonical predictions collapse toward
                                  # a marginal mean (mug frames with the
                                  # handle occluded) — a systematic ~5 cm
                                  # center-vote overshoot; the scale head
                                  # stays calibrated on the same frames, so
                                  # "head" removes the bias (hidden-handle
                                  # 5°5cm 0.0 -> 0.5 measured). "split" is
                                  # exact under the collapse model but a
                                  # measured NEGATIVE on real predictions —
                                  # per-pair dy noise leaks into the xz
                                  # factor (visible-handle 0.70 -> 0.40);
                                  # kept as the tested record of that result.
                                  # "pair" = reference semantics.
    arbiter: str = "margin"       # ensemble branch selection:
                                  #  "recon" — each branch's own clipped
                                  #    reconstruction loss, ties to visual
                                  #    (reference semantics, eval.py:358-372);
                                  #  "cross" — each pose scored on BOTH
                                  #    branches' kept-pair predictions (mean
                                  #    of the two yardsticks). A branch whose
                                  #    predictions are self-consistently
                                  #    wrong (the round-3 laptop failure:
                                  #    a random-backbone visual branch won
                                  #    24% of frames at 0.125 accuracy) can
                                  #    game its own yardstick but it also
                                  #    drags GOOD geo poses toward its own
                                  #    broken yardstick — measured WORST of
                                  #    the three (laptop n=100 paired, 20k
                                  #    pairs: cross 0.49 / recon 0.59 /
                                  #    margin 0.72 at 5°5cm,
                                  #    benchmarks/r4_arbiter_laptop);
                                  #  "margin" — reference rule, but the
                                  #    visual branch overrides geo only when
                                  #    it wins by `arbiter_margin`. Default:
                                  #    the ensemble never underperforms its
                                  #    stronger branch (laptop 0.72 vs 0.73
                                  #    geo-only; visual picked on 1% of
                                  #    frames with the random backbone, and
                                  #    a trained visual branch still wins
                                  #    whenever it is clearly better).
    arbiter_margin: float = 0.005 # margin for arbiter="margin"
    yaw_sweep: Optional[bool] = None  # post-alignment feature-weighted yaw
                                  # micro-sweep (infer/alignment.py::
                                  # yaw_sweep); None = the category default
                                  # (CategoryConfig.yaw_sweep)

    @property
    def num_kept_pairs(self) -> int:
        return int(self.num_pairs * self.backproj_ratio)

    @property
    def sphere_samples(self) -> int:
        import math

        return int(4 * math.pi / (self.angle_tol_deg / 180.0 * math.pi))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: train_shot.py:124-130, 141; config/config.yaml)."""

    lr: float = 1e-3
    weight_decay: float = 0.0
    lr_step_epochs: int = 25
    lr_gamma: float = 0.5
    max_epochs: int = 101
    tuples_per_step: int = 10000   # reference: train_shot.py:88
    steps_per_epoch: int = 200     # reference: dataset.py:364 virtual epoch length
    batch_size: int = 1            # frames per device per step
    n_points: int = 1024           # padded per-frame point budget for training
    num_bins: int = 32
    seed: int = 0
