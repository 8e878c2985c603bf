"""The system under test: `cppf2_torch`'s frame driver, built as a
configuration file says.

This is the one module of the harness that imports the program. It builds
the kernels, loads the branch models from the configuration's checkpoint
root, makes the ViT from the seed (`perfbench/weights.py`), and exposes the
timed path: the draws of a frame (`driver.draw_instance` in detection order,
from a torch.Generator seeded from `--seed`, as `evaluate_real275` makes
them), `driver.dispatch_frame` and `driver.fetch_frames`. `Taps` wraps the
driver's visual stages and group programs from outside: spans for the traced
run, and the outputs of the frames the check samples.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.weights import load_vit, vit_tensors


class System:
    def __init__(self, cfg: Dict, seed: int, device):
        from cppf2_torch.config import PipelineConfig
        from cppf2_torch.device import resolve_device
        from cppf2_torch.eval import driver
        from cppf2_torch.models.dinov2 import DinoFeatureExtractor, DinoViT, ViTConfig

        self.driver = driver
        self.dev = resolve_device(device)
        if self.dev.type == "cuda":
            from cppf2_torch.ops import _build

            _build.build()
        self.pipe = PipelineConfig(**cfg["pipeline"])
        self.buckets = tuple(cfg["buckets"])
        self.cfg = cfg
        if cfg["precision"] != {"vit": "bfloat16", "branches": "bfloat16", "pose_graph": "float32"}:
            raise ValueError(f"the frame driver serves the ViT and the branches in bfloat16 and the "
                             f"pose graph in float32, not {cfg['precision']}")
        v = cfg["vit"]
        vcfg = ViTConfig(patch_size=v["patch_size"], embed_dim=v["embed_dim"], depth=v["depth"],
                         num_heads=v["num_heads"], mlp_ratio=v["mlp_ratio"],
                         pretrain_grid=v["pretrain_grid"])
        self.models = driver.load_category_models(cfg["branches"], cfg["categories"],
                                                  compute_dtype=torch.bfloat16, device=self.dev)
        tensors = vit_tensors(v, seed, self.dev)
        if cfg["route"] == "vit":
            with torch.device(self.dev):
                vit = DinoViT(vcfg)
            load_vit(vit, tensors).eval().cast_for_inference()
            self.backbone = vit
            self.route = dict(vit=vit, stride=cfg["stride"], out_size=cfg["crop"])
        elif cfg["route"] == "extractor":
            ext = DinoFeatureExtractor(cfg=vcfg, stride=cfg["stride"], out_size=cfg["crop"],
                                       device=self.dev)
            load_vit(ext.model, tensors)
            ext._cast()
            self.backbone = ext.model
            self.route = dict(dino_extractor=ext)
        else:
            raise ValueError(f"unknown route {cfg['route']!r}")
        del tensors

    def draws(self, frame, gen: torch.Generator):
        """One InstanceDraws per detection, in detection order."""
        return [self.driver.draw_instance(frame.depth.shape, m, cat, self.pipe, self.dev, gen)
                for cat, m in frame.dets]

    def dispatch(self, frame, intrinsics, draws):
        return self.driver.dispatch_frame(frame.rgb, frame.depth, frame.dets, intrinsics, self.models,
                                          self.pipe, device=self.dev, draws=draws,
                                          buckets=self.buckets, **self.route)

    def fetch(self, pendings):
        return self.driver.fetch_frames(pendings, return_picks=True)

    def close(self) -> None:
        """Free the models, the backbone and every program that holds them."""
        self.driver._FRONTENDS.clear()
        self.models = self.backbone = self.route = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def rows_of(pendings) -> np.ndarray:
    """The (instances, 22) rows a frame's pendings hold, in detection order:
    count, extent (3), rotation (9), translation (3), scale (3), scale norm,
    loss, pick, as the driver packs them. Read after the window."""
    got = {}
    for p in pendings:
        if hasattr(p, "idxs"):
            rows = p.dev[:len(p.idxs)].reshape(-1, 22).float().cpu().numpy()
            got.update(zip(p.idxs, rows))
        else:
            got[p[0]] = p[1].dev.reshape(22).float().cpu().numpy()
    return np.stack([got[i] for i in sorted(got)])


class Taps:
    """Wraps the driver's units from outside. `spans`: a profiler range
    around every ViT stage and instance visual stage ("perfbench.vit"),
    every group program's replay ("perfbench.group"), every singles route
    ("perfbench.single"), and counts of what they ran. `keep`: while it is
    set, the visual stages' outputs are kept for the check."""

    def __init__(self, driver, spans: bool):
        self.driver, self.spans = driver, spans
        self.keep: Optional[Dict] = None
        self.vit_calls: List[int] = []   # crops of each ViT forward, singles as 1
        self.group_rows: List[int] = []  # instances (padding included) of each group replay
        self.orig = {}

    def _range(self, name):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __enter__(self):
        d = self.driver
        self.orig = {n: getattr(d, n) for n in ("_vit_stage", "_instance_visual", "_group_program",
                                                "dispatch_instance")}
        o = self.orig

        def vit_stage(backbone, stride, out_size, batches, rgb_u8, masks):
            with self._range("perfbench.vit"):
                out = o["_vit_stage"](backbone, stride, out_size, batches, rgb_u8, masks)
            self.vit_calls.append(int(sum(batches)))
            if self.keep is not None:
                self.keep.setdefault("stages", []).append((tuple(batches), out, masks))
            return out

        def instance_visual(rgb, mask, mask_t, pixel_yx, *args, **kw):
            with self._range("perfbench.vit"):
                out = o["_instance_visual"](rgb, mask, mask_t, pixel_yx, *args, **kw)
            self.vit_calls.append(1)
            if self.keep is not None:
                self.keep.setdefault("singles_desc", []).append((pixel_yx, out))
            return out

        def group_program(models, cat, pipe, run_opt, use_visual, use_geo, crop, stride, ext_key,
                          batch, args):
            prog = o["_group_program"](models, cat, pipe, run_opt, use_visual, use_geo, crop,
                                       stride, ext_key, batch, args)

            def call(*a):
                with self._range("perfbench.group"):
                    out = prog(*a)
                self.group_rows.append(int(batch))
                return out
            return call

        def dispatch_instance(*args, **kw):
            with self._range("perfbench.single"):
                return o["dispatch_instance"](*args, **kw)

        d._vit_stage, d._instance_visual = vit_stage, instance_visual
        d._group_program, d.dispatch_instance = group_program, dispatch_instance
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.driver, n, f)
        return False
