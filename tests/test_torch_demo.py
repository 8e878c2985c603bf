"""The port's demo (`cppf2_torch/demo.py`) against the JAX package's on
tabletop frames made from seeds (`tests/test_segmenter.py::tabletop_scene`):

  * `auto_instance_mask`: the ranked pick, an out-of-range `mask_index`,
    identity tracking by IoU across frames, and the depth-band fallback,
    equal to JAX's mask for mask;
  * `run_frame` with a small extractor (embed 1024 for the dino branch,
    depth 1, stride 8: 1025 tokens keep the CPU run short, where the card
    runs stride 4) and the JAX draws injected: the voted pose (no
    alignment) within 1e-5, the aligned pose within R 0.5 deg and T 2 mm,
    the slice's tolerances;
  * `main` on two frames with `--device cpu`, writing overlay PNGs and
    `_pose.npz` files, from `--auto-mask` and from mask files;
  * `--video-out` and a JPEG frame raise before any frame runs.
"""

import os

import jax
import numpy as np
import pytest
import torch

from cppf2_torch import demo as tdemo
from cppf2_torch.config import PipelineConfig as TPipe
from cppf2_torch.eval import driver as tdriver
from cppf2_torch.eval.png import read_png_rgb8, write_png16, write_png_gray8, write_png_rgb8
from cppf2_torch.infer import frontend as tfront
from cppf2_torch.models import dinov2 as tdino
from cppf2_tpu import demo as jdemo
from cppf2_tpu.config import PipelineConfig as JPipe
from cppf2_tpu.eval import driver as jdriver
from cppf2_tpu.models import dinov2 as jdino
from test_segmenter import K, tabletop_scene
from test_torch_frame_driver import PIPE, VIT, _instance_draws, _rt_angle_deg

SMALL = ["--n-points", "256", "--num-pairs", "512", "--angle-tol", "5"]


def _frames(n, objects, seed=0, step=6):
    """n tabletop frames whose objects move `step` px right per frame."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        objs = [(cx + step * i, cy, r, z) for cx, cy, r, z in objects]
        depth, gts = tabletop_scene(rng, objs)
        out.append((rng.integers(0, 256, size=(480, 640, 3)).astype(np.uint8), depth, gts))
    return out


def test_auto_instance_mask_matches_jax():
    """Two scale-compatible objects on a table over three frames: the ranked
    pick for mask_index 0 and 1, an out-of-range index (the last proposal),
    and the tracked pick from the previous frame's mask, all equal to JAX's;
    tracking keeps the object picked on the first frame. A bare plane falls
    back to the depth band (from_proposal False) in both."""
    frames = _frames(3, [(200, 240, 0.08, 0.9), (460, 220, 0.07, 0.85)])
    for index in (0, 1, 7):
        prev_t = prev_j = None
        for i, (_, depth, gts) in enumerate(frames):
            mt, ft = tdemo.auto_instance_mask(depth, K, category="mug", mask_index=index,
                                              verbose=i == 0, prev_mask=prev_t)
            mj, fj = jdemo.auto_instance_mask(depth, K, category="mug", mask_index=index,
                                              prev_mask=prev_j)
            np.testing.assert_array_equal(mt, mj)
            assert ft and fj
            if i == 0:
                first = int(np.argmax([(mt & g).sum() for g in gts]))
            assert int(np.argmax([(mt & g).sum() for g in gts])) == first
            prev_t, prev_j = mt, mj
    flat, _ = tabletop_scene(np.random.default_rng(3), [])
    mt, ft = tdemo.auto_instance_mask(flat, K, category="mug")
    mj, fj = jdemo.auto_instance_mask(flat, K, category="mug")
    np.testing.assert_array_equal(mt, mj)
    assert not ft and not fj
    np.testing.assert_array_equal(tdemo.depth_band_mask(flat), jdemo.depth_band_mask(flat))


@pytest.fixture(scope="module")
def extractors():
    """The same small extractor weights in both packages (the JAX
    extractor's init), and both packages' f32 mug branches."""
    jext = jdino.DinoFeatureExtractor(cfg=jdino.ViTConfig(**VIT), stride=8)
    jext.init_random(hw=(256, 256), seed=2)
    text = tdino.DinoFeatureExtractor(params=jax.device_get(jext.params),
                                      cfg=tdino.ViTConfig(**VIT, attn_impl="hbm"), stride=8, device="cpu")
    jmodels = jdriver.load_category_models("ckpts_r3", ["mug"], infer_dtype="float32")["mug"]
    tmodels = tdriver.load_category_models("ckpts_r3", ["mug"], torch.float32, "cpu")["mug"]
    return jext, text, jmodels, tmodels


@pytest.mark.parametrize("run_opt", [False, True])
def test_run_frame_matches_jax(extractors, run_opt):
    """One tabletop frame, the mug's proposal as the mask, the JAX key's
    draws in the port: the voted pose within 1e-5 (R entries, T in m), the
    aligned one within R 0.5 deg, T 2 mm; unit scales rtol 1e-3; the overlay
    is the port's drawing of its own pose."""
    jext, text, jmodels, tmodels = extractors
    rgb, depth, _ = _frames(1, [(320, 240, 0.08, 0.9)], seed=5)[0]
    mask, _ = tdemo.auto_instance_mask(depth, K, category="mug")
    key = jax.random.key(4)
    _, jrt, jscales = jdemo.run_frame(rgb, depth, mask, "mug", jmodels, JPipe(**PIPE), intrinsics=K,
                                      key=key, dino_extractor=jext, run_opt=run_opt)
    draws = _instance_draws(key, depth.shape, tfront.auto_crop(mask))
    overlay, rt, scales = tdemo.run_frame(rgb, depth, mask, "mug", tmodels, TPipe(**PIPE), intrinsics=K,
                                          dino_extractor=text, run_opt=run_opt, device="cpu",
                                          draws=draws)
    if run_opt:
        assert _rt_angle_deg(rt, jrt) < 0.5
        np.testing.assert_allclose(rt[:3, 3], jrt[:3, 3], atol=2e-3)
    else:
        np.testing.assert_allclose(rt, jrt, atol=1e-5)
    np.testing.assert_allclose(scales, jscales, rtol=1e-3)
    np.testing.assert_array_equal(overlay, tdemo.draw_pose_overlay(rgb, rt, scales, K))
    assert (overlay != rgb).any()


def _write_capture(root, frames):
    rgb_dir, depth_dir = root / "rgb", root / "depth"
    rgb_dir.mkdir()
    depth_dir.mkdir()
    for i, (rgb, depth, _) in enumerate(frames):
        write_png_rgb8(str(rgb_dir / f"{i:03d}.png"), rgb)
        write_png16(str(depth_dir / f"{i:03d}.png"), np.round(depth * 1000).astype(np.uint16))
    np.save(root / "k.npy", K)
    return rgb_dir, depth_dir


def test_main_writes_overlays_and_poses(tmp_path, monkeypatch, extractors):
    """`main` on a two-frame capture directory with `--auto-mask` and an
    extractor (the .pth loader swapped for the small one), then on explicit
    files with mask PNGs and no extractor: one overlay PNG and one pose
    file per frame, read back through the port's reader; a finite pose with
    R * |s| in the rotation block."""
    _, text, _, _ = extractors
    frames = _frames(2, [(320, 240, 0.08, 0.9)], seed=6)
    rgb_dir, depth_dir = _write_capture(tmp_path, frames)
    monkeypatch.setattr(tdemo, "load_dino_extractor", lambda path, dev: text)
    out = tmp_path / "out"
    tdemo.main(["--rgb-dir", str(rgb_dir), "--auto-mask", "--category", "mug", "--ckpts", "ckpts_r3",
                "--dino-ckpt", "small.pth", "--out", str(out), "--intrinsics", str(tmp_path / "k.npy"),
                "--device", "cpu", "--seed", "1", *SMALL])
    for i, (rgb, _, _) in enumerate(frames):
        img = read_png_rgb8(str(out / f"{i:04d}.png"))
        assert img.shape == rgb.shape and (img != rgb).any()
        pose = np.load(out / f"{i:04d}_pose.npz")
        assert np.isfinite(pose["RT"]).all() and pose["scales"].shape == (3,)
        assert 0.6 < pose["RT"][2, 3] < 1.0
    masks = []
    for i, (_, _, gts) in enumerate(frames):
        write_png_gray8(str(tmp_path / f"m{i}.png"), gts[0].astype(np.uint8) * 255)
        masks.append(str(tmp_path / f"m{i}.png"))
    out2 = tmp_path / "out2"
    tdemo.main(["--rgb", *sorted(map(str, rgb_dir.iterdir())), "--depth", *sorted(map(str, depth_dir.iterdir())),
                "--mask", *masks, "--category", "mug", "--ckpts", "ckpts_r3", "--out", str(out2),
                "--intrinsics", str(tmp_path / "k.npy"), "--device", "cpu", "--no-opt", *SMALL])
    assert sorted(os.listdir(out2)) == ["0000.png", "0000_pose.npz", "0001.png", "0001_pose.npz"]


def test_video_out_and_jpeg_raise(tmp_path):
    """No mp4 encoder and no JPEG decoder without cv2: both stop before any
    frame runs, naming what is missing; so do a missing mask source and an
    rgb dir without 'rgb' in its path."""
    frames = _frames(1, [(320, 240, 0.08, 0.9)])
    rgb_dir, _ = _write_capture(tmp_path, frames)
    base = ["--category", "mug", "--ckpts", "ckpts_r3", "--device", "cpu", "--auto-mask",
            "--out", str(tmp_path / "o")]
    with pytest.raises(SystemExit, match="mp4"):
        tdemo.main(["--rgb-dir", str(rgb_dir), "--video-out", str(tmp_path / "v.mp4"), *base])
    (rgb_dir / "001.jpg").write_bytes(b"\xff\xd8")
    (tmp_path / "depth" / "001.png").write_bytes((tmp_path / "depth" / "000.png").read_bytes())
    with pytest.raises(SystemExit, match="JPEG"):
        tdemo.main(["--rgb-dir", str(rgb_dir), *base])
    with pytest.raises(SystemExit, match="JPEG"):
        tdemo.main(["--rgb", str(rgb_dir / "001.jpg"), "--depth", str(tmp_path / "depth" / "000.png"), *base])
    with pytest.raises(SystemExit, match="mask"):
        tdemo.main(["--rgb", str(rgb_dir / "000.png"), "--depth", str(tmp_path / "depth" / "000.png"),
                    "--category", "mug", "--device", "cpu"])
    os.rename(rgb_dir, tmp_path / "frames")
    with pytest.raises(SystemExit, match="depth-dir"):
        tdemo.main(["--rgb-dir", str(tmp_path / "frames"), *base])
    assert not (tmp_path / "o").exists()
