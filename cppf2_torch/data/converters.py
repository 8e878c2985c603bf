"""Dataset converters: Wild6D and PhoCaL into REAL275-format evaluation trees
(counterpart of `cppf2_tpu/data/converters.py`; reference
data/wild6d_convert2real275.py:20-108, data/phocal_convert2real275.py:26-142).

Both write, per frame, `{id}_color/_depth/_mask.png` (symlinks where the
source already has the file), `{id}_meta.txt`, `camK.npy` and a
`final_result` ground-truth pickle that the evaluation reads. The JAX
package reads and writes the PNGs with cv2; here they go through
`eval/png.py` (8-bit gray, RGB or RGBA and 16-bit gray). No colour frame is
decoded: Wild6D's `.jpg` frames are only linked. They run only where the
source datasets are on disk.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Iterable, Optional

import numpy as np

from cppf2_torch.config import CATEGORY2ID
from cppf2_torch.eval.png import read_png, write_png8

# PhoCaL class remap {0: bottle, 2: can, 3: cup->mug}
# (phocal_convert2real275.py:20-24)
PHOCAL_CLASS2NOCS = {0: 1, 2: 4, 3: 6}


def _symlink(src: str, dst: str):
    if not os.path.exists(dst):
        os.symlink(os.path.abspath(src), dst)


def convert_wild6d(
    test_set_root: str,
    out_root: Optional[str] = None,
    class_names: Iterable[str] = ("mug", "bottle", "bowl", "camera", "laptop"),
) -> int:
    """Convert Wild6D test annotations into the REAL275 layout (the frames
    of `test_list_<class>.txt` that have an image, a depth and a mask; the
    mask is written as 0/1). Returns the number of frames converted."""
    out_root = out_root or os.path.join(test_set_root, "real275_fmt")
    converted = 0
    for class_name in class_names:
        list_path = os.path.join(test_set_root, f"test_list_{class_name}.txt")
        if not os.path.isfile(list_path):
            continue
        test_list = set()
        with open(list_path) as f:
            for line in f:
                parts = line.strip().split("/")
                test_list.add((parts[-5], parts[-4], parts[-3], parts[-1][:-4]))

        for ann_path in sorted(
            glob.glob(os.path.join(test_set_root, "pkl_annotations", class_name, "*.pkl"))
        ):
            with open(ann_path, "rb") as f:
                anns = pickle.load(f)
            for ann in anns["annotations"]:
                cls_n, seq_idx, obj_idx, frame_idx = ann["name"].split("/")
                if cls_n == "cup":
                    cls_n = "mug"
                if (cls_n, seq_idx, obj_idx, str(int(frame_idx))) not in test_list:
                    continue
                base = os.path.join(test_set_root, cls_n, seq_idx, obj_idx)
                img = os.path.join(base, "images", f"{int(frame_idx)}.jpg")
                depth = img[:-4] + "-depth.png"
                mask = img[:-4] + "-mask.png"
                if not all(os.path.isfile(p) for p in (img, depth, mask)):
                    continue

                out_dir = os.path.join(out_root, cls_n, seq_idx, obj_idx)
                os.makedirs(out_dir, exist_ok=True)
                img_id = f"{int(frame_idx):04d}"
                _symlink(img, os.path.join(out_dir, f"{img_id}_color.png"))
                _symlink(depth, os.path.join(out_dir, f"{img_id}_depth.png"))
                write_png8(os.path.join(out_dir, f"{img_id}_mask.png"),
                           (read_png(mask) > 0).astype(np.uint8))
                with open(os.path.join(out_dir, f"{img_id}_meta.txt"), "w") as f:
                    f.write(f"0 {CATEGORY2ID[cls_n]} {cls_n}\n")
                with open(os.path.join(base, "metadata"), "rb") as f:
                    meta = json.load(f)
                np.save(os.path.join(out_dir, "camK.npy"), np.array(meta["K"]).reshape(3, 3).T)
                rt = np.eye(4)
                rt[:3, :3] = ann["rotation"]
                rt[:3, 3] = ann["translation"]
                final_result = {
                    "image_path": img,
                    "gt_class_ids": [CATEGORY2ID[cls_n]],
                    "gt_bboxes": [],
                    "gt_RTs": [rt],
                    "gt_scales": [ann["size"]],
                    "gt_handle_visibility": [1],
                }
                with open(os.path.join(out_dir, f"{img_id}.pkl"), "wb") as f:
                    pickle.dump(final_result, f)
                converted += 1
    return converted


def convert_phocal(release_root: str, out_root: Optional[str] = None) -> int:
    """Convert PhoCaL sequences into the REAL275 layout, with the
    reference's axis swap for the rotation-symmetric classes (z -> -y,
    y -> z; scale [0, 2, 1], phocal_convert2real275.py:101-105). An
    instance without a valid depth pixel under its mask is left out.
    Returns the number of frames converted."""
    out_root = out_root or os.path.join(release_root, "real275_fmt")
    with open(os.path.join(release_root, "class_obj_taxonomy.json")) as f:
        taxonomy = json.load(f)

    converted = 0
    for seq_path in sorted(glob.glob(os.path.join(release_root, "sequence_*"))):
        with open(os.path.join(seq_path, "scene_camera.json")) as f:
            cam = json.load(f)["rgb"]
        k = np.eye(3)
        k[0, 0], k[1, 1] = cam["fx"], cam["fy"]
        k[0, 2], k[1, 2] = cam["cx"], cam["cy"]
        depth_scale = float(cam["depth_scale"])

        split = np.load(os.path.join(seq_path, "train_test_split.npz"))
        test_idxs = set(int(i) for i in split["test_idxs"])
        with open(os.path.join(seq_path, "rgb_scene_gt.json")) as f:
            scene_gt = json.load(f)

        out_dir = os.path.join(out_root, os.path.basename(seq_path))
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "camK.npy"), k)

        for frame_key, rt_infos in scene_gt.items():
            if int(frame_key) not in test_idxs:
                continue
            img_id = f"{int(frame_key):06d}"
            depth_path = os.path.join(seq_path, "depth", f"{img_id}.png")
            mask_path = os.path.join(seq_path, "mask", f"{img_id}.png")
            rgb_path = os.path.join(seq_path, "rgb", f"{img_id}.png")
            if not all(os.path.isfile(p) for p in (depth_path, mask_path, rgb_path)):
                continue
            depth = read_png(depth_path) / depth_scale
            mask = read_png(mask_path)
            _symlink(rgb_path, os.path.join(out_dir, f"{img_id}_color.png"))
            _symlink(depth_path, os.path.join(out_dir, f"{img_id}_depth.png"))
            _symlink(mask_path, os.path.join(out_dir, f"{img_id}_mask.png"))

            final_result = {
                "image_path": os.path.join(out_dir, f"{img_id}_color.png"),
                "gt_class_ids": [], "gt_bboxes": [], "gt_RTs": [],
                "gt_scales": [], "gt_handle_visibility": [], "gt_mids": [],
            }
            meta_lines = []
            for mid, info in enumerate(rt_infos):
                cls = info["class_id"]
                if cls not in PHOCAL_CLASS2NOCS:
                    continue
                nocs_cls = PHOCAL_CLASS2NOCS[cls]
                inst_mask = mask == (mid + 1)
                if np.sum((depth > 0) & inst_mask) == 0:
                    continue
                rt = np.eye(4)
                rt[:3, :3] = np.array(info["cam_R_m2c"]).reshape(3, 3)
                rt[:3, 3] = np.array(info["cam_t_m2c"])
                scale = np.array(taxonomy[str(cls)]["scales"][str(info["inst_id"])])
                if nocs_cls in (1, 4, 6):  # symmetric classes: z-up -> y-up
                    z = rt[:3, 2].copy()
                    rt[:3, 2] = -rt[:3, 1]
                    rt[:3, 1] = z
                    scale = scale[[0, 2, 1]]
                meta_lines.append(
                    f"{mid} {nocs_cls} {taxonomy[str(cls)]['objs'][str(info['inst_id'])]}")
                final_result["gt_class_ids"].append(nocs_cls)
                final_result["gt_mids"].append(mid + 1)
                final_result["gt_RTs"].append(rt)
                final_result["gt_scales"].append(scale)
                final_result["gt_handle_visibility"].append(1)
            with open(os.path.join(out_dir, f"{img_id}_meta.txt"), "w") as f:
                f.write("\n".join(meta_lines) + ("\n" if meta_lines else ""))
            with open(os.path.join(out_dir, f"{img_id}.pkl"), "wb") as f:
                pickle.dump(final_result, f)
            converted += 1
    return converted
