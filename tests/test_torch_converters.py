"""The dataset converters of the port (`cppf2_torch/data/converters.py`)
against the JAX package's, which read and write PNGs with cv2: small fake
Wild6D and PhoCaL trees (pickled annotations, metadata, JSONs, 8-bit gray,
8-bit RGB and 16-bit PNGs) go through both into two directories, which
must hold the same files, links, pickles, meta text, intrinsics and masks."""

import json
import os
import pickle

import numpy as np
import pytest

from cppf2_torch.data import converters as tconv
from cppf2_torch.eval.png import read_png, write_png8, write_png16
from cppf2_tpu.data import converters as jconv

cv2 = pytest.importorskip("cv2")


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _wild6d(root, rng):
    """Two classes, three annotated frames each (one outside the test list,
    one without its depth), a 'cup' annotation mapped to mug, a gray mask
    (bottle) and an RGB one (mug) on the converted frames."""
    h, w = 24, 32
    for cls, ann_cls in (("mug", "cup"), ("bottle", "bottle")):
        lines, anns = [], []
        for seq, obj, frame in (("0001", "1", 3), ("0001", "1", 12), ("0002", "4", 7)):
            base = root / cls / seq / obj
            (base / "images").mkdir(parents=True, exist_ok=True)
            (base / "images" / f"{frame}.jpg").write_bytes(b"\xff\xd8 not decoded \xff\xd9")
            if frame != 7:
                depth = rng.integers(0, 2000, size=(h, w)).astype(np.uint16)
                write_png16(str(base / "images" / f"{frame}-depth.png"), depth)
            mask = (rng.uniform(size=(h, w)) < 0.4).astype(np.uint8) * 255
            if frame == 12 and cls == "mug":
                mask = np.stack([mask, mask // 2, np.zeros_like(mask)], -1)   # an RGB mask
            write_png8(str(base / "images" / f"{frame}-mask.png"), mask)
            with open(base / "metadata", "w") as f:
                json.dump({"K": rng.uniform(100, 600, size=9).tolist(), "w": w, "h": h}, f)
            if frame != 3:
                lines.append(f"/data/test_set/{cls}/{seq}/{obj}/images/{frame}.jpg")
            anns.append({"name": f"{ann_cls}/{seq}/{obj}/{frame:04d}", "rotation": _rot(rng),
                         "translation": rng.normal(size=3), "size": rng.uniform(0.05, 0.3, 3)})
        (root / f"test_list_{cls}.txt").write_text("\n".join(lines) + "\n")
        (root / "pkl_annotations" / cls).mkdir(parents=True)
        with open(root / "pkl_annotations" / cls / "a.pkl", "wb") as f:
            pickle.dump({"annotations": anns}, f)


def _phocal(root, rng):
    """Two sequences, three frames each (one not in the test split), masks
    with instance ids, classes kept (bottle, can, cup) and left out."""
    h, w = 24, 32
    root.mkdir(parents=True)
    taxonomy = {str(c): {"scales": {str(i): rng.uniform(0.05, 0.2, 3).tolist() for i in (1, 2)},
                         "objs": {str(i): f"obj_{c}_{i}" for i in (1, 2)}} for c in (0, 1, 2, 3)}
    (root / "class_obj_taxonomy.json").write_text(json.dumps(taxonomy))
    for s in range(2):
        seq = root / f"sequence_{s:02d}"
        for sub in ("depth", "mask", "rgb"):
            (seq / sub).mkdir(parents=True)
        (seq / "scene_camera.json").write_text(json.dumps(
            {"rgb": {"fx": 600.5, "fy": 601.25, "cx": 16.0, "cy": 12.5, "depth_scale": 4.0}}))
        np.savez(seq / "train_test_split.npz", test_idxs=np.array([0, 2]), train_idxs=np.array([1]))
        gt = {}
        for frame in range(3):
            iid = f"{frame:06d}"
            depth = rng.integers(0, 3000, size=(h, w)).astype(np.uint16)
            depth[:, :4] = 0            # instance 3 lies where there is no depth
            write_png16(str(seq / "depth" / f"{iid}.png"), depth)
            mask = np.zeros((h, w), np.uint8)
            mask[2:10, 5:15] = 1
            mask[12:20, 10:30] = 2
            mask[:, :4] = 3
            mask[20:, 5:9] = 4
            write_png8(str(seq / "mask" / f"{iid}.png"), mask)
            write_png8(str(seq / "rgb" / f"{iid}.png"), rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
            gt[str(frame)] = [
                {"class_id": c, "cam_R_m2c": _rot(rng).ravel().tolist(),
                 "cam_t_m2c": rng.normal(size=3).tolist(), "inst_id": 1 + (k % 2)}
                for k, c in enumerate((0, 3, 2, 1))]
        (seq / "rgb_scene_gt.json").write_text(json.dumps(gt))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def _same_value(a, b, path):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same_value(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


def _compare(jout, tout):
    jt, tt = _tree(jout), _tree(tout)
    assert sorted(jt) == sorted(tt) and jt
    for rel in jt:
        j, t = jt[rel], tt[rel]
        assert os.path.islink(j) == os.path.islink(t), rel
        if os.path.islink(j):
            assert os.readlink(j) == os.readlink(t), rel
        elif rel.endswith(".pkl"):
            with open(j, "rb") as f:
                jv = pickle.load(f)
            with open(t, "rb") as f:
                tv = pickle.load(f)
            jv["image_path"] = jv["image_path"].replace(str(jout), "OUT")
            tv["image_path"] = tv["image_path"].replace(str(tout), "OUT")
            _same_value(jv, tv, rel)
        elif rel.endswith(".npy"):
            a, b = np.load(j), np.load(t)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        elif rel.endswith(".png"):
            # a written mask: the same pixels through cv2 and through the port's reader
            want = cv2.imread(j, -1)
            got = read_png(t)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want if want.ndim == 2 else want[..., ::-1])
            np.testing.assert_array_equal(read_png(j), got)
        else:
            with open(j) as f, open(t) as g:
                assert f.read() == g.read(), rel


def test_convert_wild6d_matches_jax(tmp_path):
    """The same frames converted (the listed ones with depth and mask), the
    same links to the colour and depth frames, masks of 0/1 written as
    8-bit gray (three channels where the source mask had them, as cv2
    writes), meta lines, camK.npy and pickles."""
    src = tmp_path / "wild6d"
    _wild6d(src, np.random.default_rng(0))
    n_j = jconv.convert_wild6d(str(src), str(tmp_path / "j"))
    n_t = tconv.convert_wild6d(str(src), str(tmp_path / "t"))
    assert n_j == n_t == 2
    _compare(tmp_path / "j", tmp_path / "t")
    mask = read_png(str(tmp_path / "t" / "mug" / "0001" / "1" / "0012_mask.png"))
    assert mask.ndim == 3 and set(np.unique(mask)) == {0, 1}
    gray = read_png(str(tmp_path / "t" / "bottle" / "0001" / "1" / "0012_mask.png"))
    assert gray.ndim == 2 and set(np.unique(gray)) == {0, 1}


def test_convert_phocal_matches_jax(tmp_path):
    """Two sequences: the test frames, the kept classes with their axis
    swap, the instance without depth left out, the same links, meta text,
    camK.npy and pickles (image paths relative to each output)."""
    src = tmp_path / "phocal"
    _phocal(src, np.random.default_rng(1))
    n_j = jconv.convert_phocal(str(src), str(tmp_path / "j"))
    n_t = tconv.convert_phocal(str(src), str(tmp_path / "t"))
    assert n_j == n_t == 4
    _compare(tmp_path / "j", tmp_path / "t")
    with open(tmp_path / "t" / "sequence_00" / "000000.pkl", "rb") as f:
        res = pickle.load(f)
    assert res["gt_class_ids"] == [1, 6] and res["gt_mids"] == [1, 2]
    assert (tconv.PHOCAL_CLASS2NOCS == jconv.PHOCAL_CLASS2NOCS)


def test_read_png_takes_what_the_converters_read(tmp_path):
    """8-bit gray, RGB and RGBA and 16-bit gray come back as cv2.imread(-1)
    gives them (RGB order); write_png8 writes each so that cv2 reads it."""
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 255, (5, 7)).astype(np.uint8),
                rng.integers(0, 255, (5, 7, 3)).astype(np.uint8),
                rng.integers(0, 255, (5, 7, 4)).astype(np.uint8)):
        p = str(tmp_path / f"x{img.ndim}{img.shape[-1]}.png")
        write_png8(p, img)
        np.testing.assert_array_equal(read_png(p), img)
        want = cv2.imread(p, -1)
        conv = {3: cv2.COLOR_BGR2RGB, 4: cv2.COLOR_BGRA2RGBA}
        np.testing.assert_array_equal(img, want if img.ndim == 2 else cv2.cvtColor(want, conv[img.shape[-1]]))
    d = rng.integers(0, 65535, (5, 7)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), d)
    np.testing.assert_array_equal(read_png(str(tmp_path / "d.png")), d)
    with pytest.raises(ValueError):
        write_png8(str(tmp_path / "bad.png"), d)
