"""The port's evaluation against the JAX package: pose errors, 3D IoU, the
NOCS mAP, the 16-bit PNG reader, and the image-parallel REAL275 evaluator on
gloo ranks (started as in test_torch_parallel.py) against JAX's on virtual
CPU devices, fed the reference's own draws.
"""

import os
import pickle
import textwrap

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.eval import driver as tdriver
from cppf2_torch.eval import iou3d as tiou
from cppf2_torch.eval import nocs_map as tmap
from cppf2_torch.eval import pose_errors as terr
from cppf2_torch.eval import nocs_data as tnocs
from cppf2_torch.eval.png import read_png16, read_png_rgb8
from cppf2_torch.infer.frontend import auto_crop, window_shape
from cppf2_tpu.eval import driver as jdriver
from cppf2_tpu.eval import iou3d as jiou
from cppf2_tpu.eval import nocs_data as jnocs
from cppf2_tpu.eval import nocs_map as jmap
from cppf2_tpu.eval import pose_errors as jerr
from test_torch_parallel import run_ranks

PIPE = dict(n_points=512, num_pairs=1024, opt_steps=5)
CLASSES = ["bottle", "bowl", "camera", "can", "laptop", "mug"]


@pytest.fixture
def python_iou(monkeypatch):
    """Both packages' IoU on their pure-Python paths (the native cores agree
    with them only within 1e-6; `tests/test_torch_native.py` holds the
    port's native route)."""
    import cppf2_torch.native as tnative
    import cppf2_tpu.native as native

    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(tnative, "load", lambda: None)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _rt(rng, scale=1.0, base=None, noise=0.0):
    rt = np.eye(4)
    if base is None:
        rt[:3, :3] = _rot(rng) * scale
        rt[:3, 3] = rng.normal(size=3) * 0.2 + [0, 0, 0.9]
    else:
        d = _rot(rng) if noise else np.eye(3)
        ang = noise * rng.uniform()
        axis = d[:, 0]
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        r = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
        rt[:3, :3] = r @ base[:3, :3]
        rt[:3, 3] = base[:3, 3] + rng.normal(size=3) * noise * 0.1
    return rt


# ---------------------------------------------------------------------------
# numpy modules: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", CLASSES + ["phone"])
def test_pose_error_matches_jax(cls):
    rng = np.random.default_rng(len(cls))
    for vis in (0, 1):
        for _ in range(5):
            a = _rt(rng, scale=rng.uniform(0.5, 2.0))
            b = _rt(rng, base=a, noise=0.3)
            np.testing.assert_array_equal(terr.pose_error_degree_cm(a, b, cls, vis),
                                          jerr.pose_error_degree_cm(a, b, cls, vis))
    degenerate = np.zeros((4, 4))
    np.testing.assert_array_equal(terr.pose_error_degree_cm(degenerate, b, cls),
                                  jerr.pose_error_degree_cm(degenerate, b, cls))
    np.testing.assert_array_equal(terr.pose_error_degree_cm(None, b, cls), [-1.0, -1.0])


def test_assemble_rt_and_extent_match_jax():
    rng = np.random.default_rng(2)
    rot, trans, scale = _rot(rng), rng.normal(size=3), rng.uniform(0.1, 0.3, 3)
    for snorm in (0.3, 0.0):
        for got, want in zip(terr._assemble_rt(rot, trans, scale, snorm),
                             jerr._assemble_rt(rot, trans, scale, snorm)):
            np.testing.assert_array_equal(got, want)
    pc = rng.normal(size=(50, 3)).astype(np.float32)
    valid = np.arange(50) < 37
    np.testing.assert_array_equal(
        tdriver._cloud_extent(torch.from_numpy(pc), torch.from_numpy(valid)).numpy(),
        np.asarray(jdriver._cloud_extent(jnp.asarray(pc), jnp.asarray(valid))))
    np.testing.assert_array_equal(tdriver.REAL275_INTRINSICS, jdriver.REAL275_INTRINSICS)


@pytest.mark.parametrize("cls", ["can", "mug", "camera"])
def test_pairwise_iou_matches_jax(cls, python_iou):
    rng = np.random.default_rng(4)
    gts = [_rt(rng) for _ in range(3)]
    preds = [_rt(rng, base=g, noise=0.2) for g in gts] + [_rt(rng), np.zeros((4, 4))]
    ps = rng.uniform(0.1, 0.3, (len(preds), 3))
    gs = rng.uniform(0.1, 0.3, (3, 3))
    vis = np.array([0, 1, 0])
    got = tiou.pairwise_iou_matrix(np.stack(preds), ps, np.stack(gts), gs, vis, cls)
    want = jiou.pairwise_iou_matrix(np.stack(preds), ps, np.stack(gts), gs, vis, cls)
    assert got.shape == (5, 3) and got.max() > 0.1
    np.testing.assert_array_equal(got, want)


def _results(rng, n_images=3):
    out = []
    for _ in range(n_images):
        gt_cls = rng.integers(1, 7, 4)
        gt_rts = np.stack([_rt(rng, scale=rng.uniform(0.5, 2)) for _ in gt_cls])
        keep = rng.uniform(size=4) < 0.8
        pred_rts = np.stack([_rt(rng, base=g, noise=rng.uniform(0.02, 0.4)) for g in gt_rts[keep]]
                            + [_rt(rng)])
        out.append({
            "gt_class_ids": gt_cls,
            "gt_RTs": gt_rts,
            "gt_scales": rng.uniform(0.1, 0.3, (4, 3)),
            "gt_handle_visibility": rng.integers(0, 2, 4),
            "pred_class_ids": np.append(gt_cls[keep], rng.integers(1, 7)),
            "pred_RTs": pred_rts,
            "pred_scales": rng.uniform(0.1, 0.3, (len(pred_rts), 3)),
            "pred_scores": rng.uniform(size=len(pred_rts)),
        })
    return out


def test_degree_cm_map_matches_jax(python_iou, tmp_path):
    results = _results(np.random.default_rng(8))
    names = ["BG"] + CLASSES
    got = tmap.compute_degree_cm_map(results, names, str(tmp_path / "t"), verbose=False)
    want = jmap.compute_degree_cm_map(results, names, str(tmp_path / "j"), verbose=False)
    assert np.nanmax(got[0]) > 0 and np.nanmax(got[1]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["depth", "noise", "tiny"])
def test_png_reader_matches_cv2(kind, tmp_path):
    """16-bit PNGs written by cv2 (its filter heuristic uses all five row
    filters on these images) read back bit for bit."""
    rng = np.random.default_rng(1)
    ys, xs = np.mgrid[0:480, 0:640]
    if kind == "depth":
        img = np.where((xs - 300) ** 2 + (ys - 200) ** 2 < 9000,
                       820 - ((xs - 300) ** 2 + (ys - 200) ** 2) // 100, 0)
    elif kind == "noise":
        img = 800 + 200 * np.sin(xs / 37.0) * np.cos(ys / 23.0) + rng.normal(0, 3, xs.shape)
    else:
        img = rng.integers(0, 65536, (17, 31))
    img = np.clip(img, 0, 65535).astype(np.uint16)
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, img)
    got = read_png16(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, cv2.imread(path, -1))
    np.testing.assert_array_equal(got, img)


def test_png_reader_refuses_other_formats(tmp_path):
    path = str(tmp_path / "rgb.png")
    cv2.imwrite(path, np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError):
        read_png16(path)
    cv2.imwrite(path, np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError):
        read_png16(path)


@pytest.mark.parametrize("kind", ["smooth", "noise", "alpha", "tiny"])
def test_png_rgb_reader_matches_cv2(kind, tmp_path):
    """8-bit colour PNGs written by cv2 (RGB and RGBA) read back as RGB, bit
    for bit; cv2 hands back BGR, as the JAX driver then reverses."""
    rng = np.random.default_rng(2)
    ys, xs = np.mgrid[0:240, 0:320]
    if kind == "tiny":
        img = rng.integers(0, 256, (5, 7, 3))
    elif kind == "noise":
        img = rng.integers(0, 256, (240, 320, 3))
    else:
        img = np.stack([128 + 100 * np.sin(xs / (20.0 + 9 * c)) * np.cos(ys / 23.0)
                        + rng.normal(0, 2, xs.shape) for c in range(3)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    path = str(tmp_path / "c.png")
    if kind == "alpha":
        alpha = rng.integers(0, 256, img.shape[:2] + (1,)).astype(np.uint8)
        cv2.imwrite(path, np.concatenate([img[:, :, ::-1], alpha], -1))
    else:
        cv2.imwrite(path, img[:, :, ::-1])
    got = read_png_rgb8(path)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, cv2.imread(path)[:, :, ::-1])
    np.testing.assert_array_equal(got, img)


def test_png_rgb_reader_refuses_other_formats(tmp_path):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError):
        read_png_rgb8(path)
    cv2.imwrite(path, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(ValueError):
        read_png_rgb8(path)
    with pytest.raises(FileNotFoundError):
        read_png_rgb8(str(tmp_path / "missing.png"))


def test_nocs_data_copy_matches_jax(tmp_path):
    """`parse_meta` / `process_data`: the port's copy gives the JAX module's arrays."""
    rng = np.random.default_rng(3)
    mask_im = np.full((40, 50), 255, np.uint8)
    mask_im[5:15, 5:20], mask_im[20:35, 10:30], mask_im[2:6, 40:48] = 1, 2, 3
    coord = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    root = tmp_path / "obj_models"
    (root / "real_test").mkdir(parents=True)
    (root / "val" / "02876657" / "abc").mkdir(parents=True)
    np.savetxt(root / "real_test" / "mug_x_norm.txt", [0.1, 0.2, 0.3])
    np.savetxt(root / "val" / "02876657" / "abc" / "bbox.txt", [[0.3, 0.4, 0.2], [-0.3, -0.4, -0.2]])
    meta = tmp_path / "meta.txt"
    meta.write_text("1 6 mug_x_norm\n2 1 02876657 abc\n3 0 ignored_bg\n\n")
    inst = {1: 6, 2: 1, 3: 0}
    for models_root in (str(root), None):
        got = tnocs.process_data(mask_im, coord, inst, str(meta), models_root)
        want = jnocs.process_data(mask_im, coord, inst, str(meta), models_root)
        assert got[0].shape == (40, 50, 2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert [e[:2] for e in tnocs.parse_meta(str(meta))] == [e[:2] for e in jnocs.parse_meta(str(meta))]
    with pytest.raises(ValueError):
        tnocs.process_data(np.zeros((4, 4), np.uint8), coord[:4, :4], inst, str(meta))


# ---------------------------------------------------------------------------
# the image-parallel evaluator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini_real275(tmp_path_factory):
    """One REAL275-format image with two can instances, built as the JAX
    package's parallel-eval fixture builds it."""
    from cppf2_tpu.data.render import splat_render_depth
    from cppf2_tpu.data.shapes import make_category_mesh, sample_surface

    root = tmp_path_factory.mktemp("real275t")
    det_dir, img_dir = root / "detections", root / "images"
    det_dir.mkdir()
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    depth_full = np.zeros((480, 640), np.float32)
    gray_full = np.zeros((480, 640), np.float32)
    masks, rts, bounds = [], [], []
    for i in range(2):
        v, f = make_category_mesh("can", rng)
        pts, nrm = sample_surface((v, f), 120000, rng)
        r = np.eye(3, dtype=np.float32)
        t = np.array([-0.15 + 0.3 * i, 0.0, 0.9], np.float32)
        s = np.float32(0.14)
        depth, gray = splat_render_depth(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(r),
                                         jnp.asarray(t), s, jnp.asarray(jdriver.REAL275_INTRINSICS),
                                         height=480, width=640)
        depth = np.asarray(depth)
        m = depth > 0
        masks.append(m)
        keep = m & ((depth_full == 0) | (depth < depth_full))
        depth_full = np.where(keep, depth, depth_full)
        gray_full = np.where(keep, np.asarray(gray), gray_full)
        rt = np.eye(4)
        rt[:3, :3] = r
        rt[:3, 3] = t
        rts.append(rt)
        bounds.append((v.max(0) - v.min(0)) * s)
    name = "scene_1_0000"
    cv2.imwrite(str(img_dir / f"{name}_color.png"),
                (np.stack([gray_full] * 3, -1) * 255).astype(np.uint8))
    cv2.imwrite(str(img_dir / f"{name}_depth.png"), (depth_full * 1000).astype(np.uint16))
    res = {
        "image_path": f"data/real/test/{name}",
        "gt_class_ids": np.array([4, 4]),
        "gt_RTs": np.stack(rts),
        "gt_scales": np.stack(bounds).astype(np.float64),
        "gt_handle_visibility": np.array([1, 1]),
        "pred_class_ids": np.array([4, 4]),
        "pred_masks": np.stack(masks, -1),
        "pred_bboxes": np.array([[0, 0, 480, 640]] * 2),
        "pred_scores": np.array([1.0, 1.0]),
    }
    with open(det_dir / f"results_{name}.pkl", "wb") as f:
        pickle.dump(res, f)
    return str(det_dir), str(img_dir), res


def _jax_draws(key, hw, crop, pipe, tuple_size=5):
    """The draws the JAX batched graph makes from an instance key, as arrays."""
    k1, k2 = jax.random.split(key)
    h, w = window_shape(hw, crop)
    k_tuple, k_dino, k_shot = jax.random.split(k2, 3)
    shape = (pipe["num_pairs"] * 6, 32)
    return dict(perm=np.array(jax.random.permutation(k1, h * w)),
                prio=np.array(jax.random.uniform(jax.random.fold_in(k1, 1), (h * w,))),
                tuple_u=np.array(jax.random.uniform(k_tuple, (pipe["num_pairs"], tuple_size))),
                gumbel_dino=np.array(jax.random.gumbel(k_dino, shape)),
                gumbel_shot=np.array(jax.random.gumbel(k_shot, shape)))


def _save_draws(path, draws):
    np.savez(path, **{f"{i}_{k}": v for i, d in enumerate(draws) for k, v in d.items()})


# loads the draws saved by _save_draws inside a rank
_LOAD_DRAWS = """
from cppf2_torch.eval.driver import InstanceDraws
from cppf2_torch.infer.pipeline import PoseDraws
def load_draws(path):
    x = np.load(path)
    n = len({k.split("_")[0] for k in x.files})
    t = lambda i, k: torch.from_numpy(x[f"{i}_{k}"])
    return [InstanceDraws(t(i, "perm"), t(i, "prio"),
                          PoseDraws(t(i, "tuple_u"), t(i, "gumbel_dino"), t(i, "gumbel_shot")))
            for i in range(n)]
"""


def _rot_deg(a, b):
    return float(np.degrees(np.arccos(np.clip((np.trace(a.T @ b) - 1) / 2, -1, 1))))


@pytest.mark.parametrize("run_opt", [False, True], ids=["voted", "adam5"])
def test_batched_fn_world2_matches_jax(mini_real275, tmp_path, run_opt):
    """Two instances on two gloo ranks (one each) against JAX's
    make_batched_instance_fn on a 2-device mesh, f32 branches from
    ckpts_r3, the same draws. Voted pose: T and R * snorm within atol 1e-3
    (the JAX package's own tolerance for the batched graph); after 5 Adam
    steps R within 0.5 deg and T within 2 mm. Counts exact."""
    from cppf2_tpu.config import PipelineConfig as JPipe
    from cppf2_tpu.eval.parallel_eval import make_batched_instance_fn
    from cppf2_tpu.parallel import make_mesh

    det_dir, img_dir, res = mini_real275
    depth = (cv2.imread(os.path.join(img_dir, "scene_1_0000_depth.png"), -1) / 1000.0).astype(np.float32)
    masks = np.stack([res["pred_masks"][:, :, i] for i in range(2)])
    keys = jax.random.split(jax.random.key(7), 2)
    models = jdriver.load_category_models("ckpts_r3", ["can"], infer_dtype="float32")["can"]
    fn = make_batched_instance_fn(models, "can", JPipe(**PIPE), make_mesh(2), run_opt=run_opt)
    want = jax.tree.map(np.asarray, fn(jnp.asarray(np.stack([depth, depth])), jnp.asarray(masks), keys))
    _save_draws(tmp_path / "draws.npz", [_jax_draws(k, depth.shape, None, PIPE) for k in keys])
    np.savez(tmp_path / "in.npz", depth=depth, masks=masks)
    run_ranks(2, _LOAD_DRAWS + textwrap.dedent(f"""
        from cppf2_torch.config import PipelineConfig
        from cppf2_torch.eval.driver import load_category_models
        from cppf2_torch.eval.parallel_eval import make_batched_instance_fn
        from cppf2_torch.parallel import make_mesh
        x = np.load(TMP + "/in.npz")
        models = load_category_models("ckpts_r3", ["can"], torch.float32, "cpu")["can"]
        fn = make_batched_instance_fn(models, "can", PipelineConfig(**{PIPE!r}),
                                      make_mesh(device="cpu"), run_opt={run_opt})
        out = fn([x["depth"], x["depth"]], list(x["masks"]), load_draws(TMP + "/draws.npz"))
        if RANK == 0:
            np.savez(TMP + "/out.npz", *out)
    """), tmp_path)
    got = np.load(tmp_path / "out.npz")
    rot, trans, scale, snorm, loss, count, ext = (got[f"arr_{i}"] for i in range(7))
    jrot, jtrans, jscale, jsnorm, jloss, jcount, jext = want
    assert count.min() >= 32
    np.testing.assert_array_equal(count, jcount)
    np.testing.assert_allclose(ext, jext, atol=1e-6)
    if run_opt:
        for i in range(2):
            assert _rot_deg(rot[i], jrot[i]) < 0.5
        np.testing.assert_allclose(trans, jtrans, atol=2e-3)
    else:
        np.testing.assert_allclose(trans, jtrans, atol=1e-3)
        np.testing.assert_allclose(rot * snorm[:, None, None], jrot * jsnorm[:, None, None], atol=1e-3)
    np.testing.assert_allclose(scale, jscale, rtol=1e-3)


def test_batched_fn_crop_tier_matches_jax(mini_real275, tmp_path):
    """At the 256 crop tier: the port's block program, its windows cut on
    the device from (B, 2) origins the host computes from the masks, on one
    gloo rank against JAX's make_batched_instance_fn with crop=256 on a
    2-device mesh, f32 branches from ckpts_r3, the same draws, 5 Adam steps:
    counts exact, R within 0.5 deg, T within 2 mm, scales rtol 1e-3. The
    rank calls the function with the two instances, then with the first
    alone (a short block), then with both again: two block programs, the
    second call of both equal to the first to the bit."""
    from cppf2_tpu.config import PipelineConfig as JPipe
    from cppf2_tpu.eval.parallel_eval import make_batched_instance_fn
    from cppf2_tpu.parallel import make_mesh

    det_dir, img_dir, res = mini_real275
    depth = (cv2.imread(os.path.join(img_dir, "scene_1_0000_depth.png"), -1) / 1000.0).astype(np.float32)
    masks = np.stack([res["pred_masks"][:, :, i] for i in range(2)])
    assert [auto_crop(m) for m in masks] == [256, 256]
    keys = jax.random.split(jax.random.key(9), 2)
    models = jdriver.load_category_models("ckpts_r3", ["can"], infer_dtype="float32")["can"]
    fn = make_batched_instance_fn(models, "can", JPipe(**PIPE), make_mesh(2), crop=256)
    want = jax.tree.map(np.asarray, fn(jnp.asarray(np.stack([depth, depth])), jnp.asarray(masks), keys))
    _save_draws(tmp_path / "draws.npz", [_jax_draws(k, depth.shape, 256, PIPE) for k in keys])
    np.savez(tmp_path / "in.npz", depth=depth, masks=masks)
    run_ranks(1, _LOAD_DRAWS + textwrap.dedent(f"""
        from cppf2_torch.config import PipelineConfig
        from cppf2_torch.eval.driver import load_category_models
        from cppf2_torch.eval.parallel_eval import make_batched_instance_fn
        from cppf2_torch.parallel import make_mesh
        x = np.load(TMP + "/in.npz")
        models = load_category_models("ckpts_r3", ["can"], torch.float32, "cpu")["can"]
        fn = make_batched_instance_fn(models, "can", PipelineConfig(**{PIPE!r}),
                                      make_mesh(device="cpu"), crop=256)
        draws = load_draws(TMP + "/draws.npz")
        out = fn([x["depth"], x["depth"]], list(x["masks"]), draws)
        fn([x["depth"]], list(x["masks"][:1]), draws[:1])
        again = fn([x["depth"], x["depth"]], list(x["masks"]), draws)
        rows = [k for k in models._programs if k[0][0] == "rows"]
        assert len(rows) == 2 and all(k[0][6] == 256 for k in rows), rows
        assert all(np.array_equal(a, b) for a, b in zip(out, again))
        np.savez(TMP + "/out.npz", *out)
    """), tmp_path)
    got = np.load(tmp_path / "out.npz")
    rot, trans, scale, snorm, loss, count, ext = (got[f"arr_{i}"] for i in range(7))
    jrot, jtrans, jscale, jsnorm, jloss, jcount, jext = want
    assert count.min() >= 32
    np.testing.assert_array_equal(count, jcount)
    np.testing.assert_allclose(ext, jext, atol=1e-6)
    for i in range(2):
        assert _rot_deg(rot[i], jrot[i]) < 0.5
    np.testing.assert_allclose(trans, jtrans, atol=2e-3)
    np.testing.assert_allclose(scale, jscale, rtol=1e-3)


_EVAL = """
from cppf2_torch.config import PipelineConfig
from cppf2_torch.eval.parallel_eval import evaluate_real275_parallel
draws = load_draws(TMP + "/draws.npz") if {inject} else None
out = evaluate_real275_parallel({det!r}, {img!r}, TMP + "/out{world}", ckpt_root="ckpts_r3",
                                pipe=PipelineConfig(**{pipe!r}), run_opt=False, seed=5,
                                draws=draws, device="cpu")
assert (out is None) == (RANK != 0)
if RANK == 0:
    np.savez(TMP + "/aps{world}.npz", iou=out[0], pose=out[1])
"""
EVAL_PIPE = dict(PIPE, angle_tol_deg=3.0)


def _run_eval(world, det_dir, img_dir, tmp_path, inject):
    run_ranks(world, _LOAD_DRAWS + _EVAL.format(inject=inject, det=det_dir, img=img_dir, world=world,
                                                pipe=EVAL_PIPE), tmp_path)
    aps = np.load(tmp_path / f"aps{world}.npz")
    with open(tmp_path / f"out{world}" / "results_scene_1_0000.pkl", "rb") as f:
        return aps["iou"], aps["pose"], pickle.load(f)


def test_evaluate_world2_matches_world1(mini_real275, tmp_path):
    """Draws from one generator in serial order: two ranks give the pkls
    and AP tables of one rank, bit for bit."""
    det_dir, img_dir, _ = mini_real275
    iou1, pose1, res1 = _run_eval(1, det_dir, img_dir, tmp_path, inject=False)
    iou2, pose2, res2 = _run_eval(2, det_dir, img_dir, tmp_path, inject=False)
    assert not np.allclose(res1["pred_RTs"], np.eye(4))
    for k in ("pred_RTs", "pred_scales"):
        np.testing.assert_array_equal(res2[k], res1[k])
    np.testing.assert_array_equal(iou2, iou1)
    np.testing.assert_array_equal(pose2, pose1)
    assert np.isfinite(iou1[-1]).all() and np.isfinite(pose1[-1]).all()


def test_evaluate_world2_matches_jax(mini_real275, tmp_path, python_iou):
    """The port on two ranks against JAX's evaluate_real275_parallel on two
    devices, bf16 branches from ckpts_r3 on both sides, the draws of JAX's
    serial-order keys injected: AP tables within atol 0.05 (the JAX
    package's own tolerance between its serial and parallel drivers)."""
    from cppf2_tpu.config import PipelineConfig as JPipe
    from cppf2_tpu.eval.parallel_eval import evaluate_real275_parallel

    det_dir, img_dir, res = mini_real275
    key = jax.random.key(5)
    draws = []
    for i in range(2):
        key, sub = jax.random.split(key)
        mask = res["pred_masks"][:, :, i].astype(bool)
        draws.append(_jax_draws(sub, mask.shape, auto_crop(mask), EVAL_PIPE))
    _save_draws(tmp_path / "draws.npz", draws)
    iou_t, pose_t, res_t = _run_eval(2, det_dir, img_dir, tmp_path, inject=True)
    iou_j, pose_j = evaluate_real275_parallel(det_dir, img_dir, str(tmp_path / "jax"),
                                              ckpt_root="ckpts_r3", pipe=JPipe(**EVAL_PIPE),
                                              run_opt=False, seed=5, n_devices=2)
    assert iou_t.shape == iou_j.shape and pose_t.shape == pose_j.shape
    np.testing.assert_allclose(iou_t, iou_j, atol=0.05)
    np.testing.assert_allclose(pose_t, pose_j, atol=0.05)
    with open(tmp_path / "jax" / "results_scene_1_0000.pkl", "rb") as f:
        res_j = pickle.load(f)
    np.testing.assert_allclose(res_t["pred_RTs"][:, :3, 3], res_j["pred_RTs"][:, :3, 3], atol=5e-3)


# ---------------------------------------------------------------------------
# the serial frame driver
# ---------------------------------------------------------------------------

def test_evaluate_real275_matches_jax_driver(mini_real275, tmp_path, python_iou, capsys, monkeypatch):
    """`evaluate_real275` (geometry only: no backbone given) against the JAX
    driver on the same folder, the draws of the JAX driver's keys injected
    (`driver.py:771`, `:579-580`): AP tables within atol 0.05, translations
    within 5 mm, as the parallel evaluators are held. Both sides run the
    ckpts_r3 branches in float32 (the JAX driver's loader is wrapped for
    that): in bf16 the two packages' matmuls round differently, and on this
    frame and these keys that moves one instance's vote peak by 3 cm, which
    says nothing about the driver."""
    from cppf2_torch.config import PipelineConfig as TPipe
    from cppf2_torch.infer.pipeline import PoseDraws
    from cppf2_tpu.config import PipelineConfig as JPipe

    det_dir, img_dir, res = mini_real275
    masks = [res["pred_masks"][:, :, i].astype(bool) for i in range(2)]
    tier = auto_crop(masks[0])
    assert tier is not None and auto_crop(masks[1]) == tier
    _, frame_key = jax.random.split(jax.random.key(5))
    _, chunk_key = jax.random.split(frame_key)
    draws = []
    for k in jax.random.split(chunk_key, 2):
        d = {n: torch.from_numpy(v) for n, v in _jax_draws(k, masks[0].shape, tier, EVAL_PIPE).items()}
        draws.append(tdriver.InstanceDraws(d["perm"], d["prio"], PoseDraws(d["tuple_u"], d["gumbel_dino"],
                                                                         d["gumbel_shot"])))
    jload = jdriver.load_category_models
    monkeypatch.setattr(jdriver, "load_category_models",
                        lambda root, categories=None: jload(root, categories, infer_dtype="float32"))
    iou_t, pose_t = tdriver.evaluate_real275(
        det_dir, img_dir, str(tmp_path / "torch"), pipe=TPipe(**EVAL_PIPE), run_opt=False, seed=5,
        device="cpu", draws=[draws], debug=True,
        models=tdriver.load_category_models("ckpts_r3", None, torch.float32, "cpu"))
    assert capsys.readouterr().out.count("[debug] results_scene_1_0000.pkl inst") == 2
    iou_j, pose_j = jdriver.evaluate_real275(det_dir, img_dir, str(tmp_path / "jax"), "ckpts_r3",
                                             pipe=JPipe(**EVAL_PIPE), run_opt=False, seed=5)
    assert iou_t.shape == iou_j.shape and pose_t.shape == pose_j.shape
    np.testing.assert_allclose(iou_t, iou_j, atol=0.05)
    np.testing.assert_allclose(pose_t, pose_j, atol=0.05)
    with open(tmp_path / "torch" / "results_scene_1_0000.pkl", "rb") as f:
        res_t = pickle.load(f)
    with open(tmp_path / "jax" / "results_scene_1_0000.pkl", "rb") as f:
        res_j = pickle.load(f)
    assert not np.allclose(res_t["pred_RTs"], np.eye(4))
    np.testing.assert_allclose(res_t["pred_RTs"][:, :3, 3], res_j["pred_RTs"][:, :3, 3], atol=5e-3)
    np.testing.assert_allclose(res_t["pred_scales"], res_j["pred_scales"], rtol=1e-2)


def test_evaluate_real275_entry_point_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdriver.evaluate_real275(str(tmp_path), str(tmp_path), str(tmp_path / "o"), None, device="cpu")
    (tmp_path / "dino.pth").write_bytes(b"")
    # a .pth is no save_backbone pair; the .pth route names a missing file
    with pytest.raises(FileNotFoundError, match="msgpack"):
        tdriver._load_vit(str(tmp_path / "dino.pth"), torch.device("cpu"))
    with pytest.raises(FileNotFoundError, match="DINOv2"):
        tdriver.load_dino_extractor(str(tmp_path / "missing.pth"), "cpu")
    with pytest.raises(SystemExit):
        tdriver.main(["--images", "x"])


def test_debug_frame_writes_the_overlay_png(mini_real275, tmp_path, capsys):
    """`_debug_frame` prints each posed instance's errors and writes the
    frame with every posed instance's overlay as `debug/<base>.png`: the
    same lines and the same pixels as the JAX driver's (which writes through
    cv2), on poses near the ground truth; nothing is written when nothing
    was posed."""
    _, img_dir, res = mini_real275
    res = dict(res)
    rng = np.random.default_rng(0)
    rts = res["gt_RTs"].copy()
    rts[:, :3, 3] += rng.normal(0, 0.01, (2, 3))
    res["pred_RTs"] = rts
    res["pred_scales"] = res["gt_scales"] / np.linalg.norm(res["gt_scales"], axis=-1, keepdims=True)
    rgb = read_png_rgb8(os.path.join(img_dir, "scene_1_0000_color.png"))
    tdriver._debug_frame(res, [0, 1], "results_scene_1_0000.pkl", rgb, str(tmp_path / "t"))
    out_t = capsys.readouterr().out
    jdriver._debug_frame(res, [0, 1], "results_scene_1_0000.pkl", rgb, str(tmp_path / "j"))
    assert out_t == capsys.readouterr().out and out_t.count("[debug]") == 2
    got = read_png_rgb8(str(tmp_path / "t" / "debug" / "results_scene_1_0000.png"))
    want = cv2.imread(str(tmp_path / "j" / "debug" / "results_scene_1_0000.png"))[:, :, ::-1]
    np.testing.assert_array_equal(got, want)
    assert (got != rgb).any()
    tdriver._debug_frame(res, [], "results_none.pkl", rgb, str(tmp_path / "none"))
    assert not (tmp_path / "none").exists()


def test_evaluate_real275_reads_a_dinov2_pth(mini_real275, tmp_path, monkeypatch):
    """`evaluate_real275(dino_ckpt=<.pth>)` with no save_backbone pair beside
    it ports the official state dict and runs the JAX driver's extractor
    route: the same result pkls as handing it the extractor built from that
    dict. The production route builds ViT-L/14 at stride 4; here the
    loader's configuration is a depth-1 embed-1024 ViT at stride 8 (the
    factory is wrapped), which the CPU runs in seconds."""
    from cppf2_torch.config import PipelineConfig as TPipe
    from cppf2_torch.models import dinov2 as tdino
    from test_torch_weights import _dinov2_state_dict

    det_dir, img_dir, _ = mini_real275
    cfg = tdino.ViTConfig(embed_dim=1024, depth=1, num_heads=16, pretrain_grid=4, compute_dtype="float32")
    sd = _dinov2_state_dict(cfg, seed=2)
    torch.save(sd, tmp_path / "dinov2.pth")
    real_params, real_ext = tdriver.load_dinov2_params, tdriver.DinoFeatureExtractor
    monkeypatch.setattr(tdriver, "load_dinov2_params", lambda path: real_params(path, cfg))
    monkeypatch.setattr(tdriver, "DinoFeatureExtractor",
                        lambda params, device: real_ext(params=params, cfg=cfg, stride=8, device=device))
    models = tdriver.load_category_models("ckpts_r3", None, torch.float32, "cpu")
    kw = dict(pipe=TPipe(**EVAL_PIPE), run_opt=False, device="cpu", models=models)
    tdriver.evaluate_real275(det_dir, img_dir, str(tmp_path / "pth"), dino_ckpt=str(tmp_path / "dinov2.pth"),
                             **kw)
    ext = real_ext(params=tdino.port_torch_state_dict(sd, cfg), cfg=cfg, stride=8, device="cpu")
    tdriver.evaluate_real275(det_dir, img_dir, str(tmp_path / "ext"), dino_extractor=ext, **kw)
    tdriver.evaluate_real275(det_dir, img_dir, str(tmp_path / "geo"), **kw)
    out = {}
    for name in ("pth", "ext", "geo"):
        with open(tmp_path / name / "results_scene_1_0000.pkl", "rb") as f:
            out[name] = pickle.load(f)["pred_RTs"]
    np.testing.assert_array_equal(out["pth"], out["ext"])
    assert not np.array_equal(out["pth"], out["geo"])   # the visual branch took part
    with pytest.raises(FileNotFoundError):
        tdriver.evaluate_real275(det_dir, img_dir, str(tmp_path / "x"), dino_ckpt=str(tmp_path / "no.pth"), **kw)
