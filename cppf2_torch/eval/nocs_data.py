"""NOCS ground-truth parsing (REAL275 layout), on numpy alone.

The port's own copy of `cppf2_tpu/eval/nocs_data.py`, the equivalent of the
reference's `process_data` (utils/util.py:2959-3054): parse
the instance-id mask png, the NOCS coordinate map, meta.txt, and per-instance
model bboxes into (masks, coords, class_ids, scales)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def parse_meta(meta_path: str, obj_models_root: Optional[str] = None):
    """Parse meta.txt lines -> list of (inst_id, class_id, model_ref, scale3).

    Real scans (3 tokens) read their scale from obj_models/real_test/<name>.txt
    and unit-normalize it; CAMERA objects (4 tokens) read bbox.txt extents
    (utils/util.py:2990-3016)."""
    entries = []
    with open(meta_path) as f:
        for line in f:
            words = line.strip().split(" ")
            if len(words) < 3:
                continue
            inst_id, cls_id = int(words[0]), int(words[1])
            scale = np.ones(3, np.float32)
            if obj_models_root is not None:
                if len(words) == 3:
                    p = os.path.join(obj_models_root, "real_test", words[2] + ".txt")
                    if os.path.exists(p):
                        scale = np.loadtxt(p).astype(np.float32)
                        scale = scale / np.linalg.norm(scale)
                else:
                    for split in ("train", "val"):
                        p = os.path.join(obj_models_root, split, words[2], words[3], "bbox.txt")
                        if os.path.exists(p):
                            bbox = np.loadtxt(p)
                            scale = (bbox[0] - bbox[1]).astype(np.float32)
                            break
            entries.append((inst_id, cls_id, words[2:], scale))
    return entries


def process_data(
    mask_im: np.ndarray,
    coord_map: np.ndarray,
    inst_dict: Dict[int, int],
    meta_path: str,
    obj_models_root: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a NOCS frame's gt (utils/util.py:2959-3054).

    Args:
        mask_im: (H, W) instance-id image (255 = background).
        coord_map: (H, W, 3) NOCS coord map (uint8).
        inst_dict: instance id -> class id (0 entries are dropped).
        meta_path: meta.txt path.
    Returns:
        masks (H, W, N) uint8, coords (H, W, N, 3) float32 in [0,1],
        class_ids (N,), scales (N, 3).
    """
    cdata = np.asarray(mask_im, np.int32)
    instance_ids = sorted(np.unique(cdata).tolist())
    if instance_ids[-1] != 255:
        raise ValueError("background id 255 missing from the instance mask")
    instance_ids = instance_ids[:-1]

    coord_map = np.asarray(coord_map, np.float32) / 255.0
    coord_map = coord_map.copy()
    coord_map[:, :, 2] = 1.0 - coord_map[:, :, 2]  # z flip (utils/util.py:2979)

    entries = parse_meta(meta_path, obj_models_root)
    scale_by_inst = {inst_id: s for inst_id, _, _, s in entries}

    h, w = cdata.shape
    live = [
        i for i in instance_ids if inst_dict.get(i, 0) != 0 and i in scale_by_inst
    ]
    n = len(live)
    masks = np.zeros((h, w, n), np.uint8)
    coords = np.zeros((h, w, n, 3), np.float32)
    class_ids = np.zeros(n, np.int64)
    scales = np.zeros((n, 3), np.float32)
    for k, inst_id in enumerate(live):
        m = cdata == inst_id
        masks[:, :, k] = m
        coords[:, :, k] = coord_map * m[..., None]
        class_ids[k] = inst_dict[inst_id]
        scales[k] = scale_by_inst[inst_id]
    return masks, np.clip(coords, 0, 1), class_ids, scales
