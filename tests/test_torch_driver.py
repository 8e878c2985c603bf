"""The slice end to end: `cppf2_torch.eval.driver.estimate_instance` on a
shrunk bench-style frame (depth + mask + RGB, a tiny ViT) against the same
JAX graph the bench times as e2e_full, with the reference's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.config import PipelineConfig as TPipe
from cppf2_torch.eval import driver as tdriver
from cppf2_torch.infer.frontend import window_shape
from cppf2_torch.infer.pipeline import PoseDraws
from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import DinoBranch as TDino
from cppf2_torch.models.cppf import ShotBranch as TShot
from cppf2_torch.models.porting import load_branch, load_vit
from cppf2_tpu.config import CATEGORIES as J_CATEGORIES
from cppf2_tpu.config import PipelineConfig as JPipe
from cppf2_tpu.infer.frontend import auto_crop, preprocess_frame
from cppf2_tpu.infer.pipeline import estimate_pose_ensemble
from cppf2_tpu.models import DinoBranch as JDino
from cppf2_tpu.models import ShotBranch as JShot
from cppf2_tpu.models import dinov2 as jdino

K = np.array([[591.0125, 0.0, 162.525], [0.0, 590.16775, 124.11084], [0.0, 0.0, 1.0]], np.float32)
PIPE = dict(n_points=512, num_pairs=2000, angle_tol_deg=5.0)
OUT, STRIDE = 32, 8


def _frame(h=240, w=320, radius=0.05, center=(0.02, -0.01, 0.7)):
    """bench.py::make_frame at a quarter of the pixels: a sphere cap at 0.7 m."""
    rng = np.random.default_rng(0)
    cx, cy, cz = center
    fx, fy = K[0, 0], K[1, 1]
    uu = K[0, 2] - fx * cx / cz
    vv = K[1, 2] - fy * cy / cz
    ys, xs = np.mgrid[0:h, 0:w]
    rpix = radius * fx / cz
    d2 = (xs - uu) ** 2 + (ys - vv) ** 2
    mask = d2 < rpix ** 2
    bump = np.sqrt(np.maximum(radius ** 2 - d2 * (cz / fx) ** 2, 0.0))
    depth = np.where(mask, cz - bump + rng.normal(0, 3e-4, (h, w)), 0.0).astype(np.float32)
    rgb = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    return rgb, depth, mask


def _models():
    vit_kw = dict(embed_dim=64, depth=2, num_heads=4, layerscale_init=1.0, compute_dtype="float32")
    jvit = jdino.DinoViT(jdino.ViTConfig(**vit_kw, attn_impl="pallas", attn_block_q=128))
    vp = jvit.init(jax.random.key(0), jnp.zeros((56, 56, 3)))
    tvit = load_vit(tdino.DinoViT(tdino.ViTConfig(**vit_kw)), jax.device_get(vp))
    shot_p = load_params_msgpack("ckpts_r3/shot/mug/params.msgpack")
    jdino_m = JDino(desc_dim=64)
    dp = jax.device_get(jdino_m.init(jax.random.key(1), jnp.zeros((16, 3)), jnp.zeros((16, 64)),
                                     jnp.zeros((8, 5), jnp.int32)))
    tmodels = tdriver.CategoryModels(load_branch(TShot(), shot_p),
                                     load_branch(TDino(desc_dim=64), dp))
    return jvit, vp, JShot(), shot_p, jdino_m, dp, tvit, tmodels


def _jax_instance(rgb, depth, mask, key, jvit, vp, jshot_m, sp, jdino_m, dp, pipe):
    cat = J_CATEGORIES["mug"]
    crop = auto_crop(mask)
    mask_j = jnp.asarray(mask)

    @jax.jit
    def run(vp, sp, dp, rgb, depth, key):
        k1, k2 = jax.random.split(key)
        fi = preprocess_frame(depth, mask_j, jnp.asarray(K), k1, res=cat.res,
                              n_max=pipe.n_points, shot_k=pipe.neighbor_k, crop=crop)
        desc = jdino.bbox_crop_descriptors(jvit, vp, rgb, mask_j, fi.pixel_yx, out_size=OUT,
                                           stride=STRIDE)
        return estimate_pose_ensemble(
            lambda p, pts, ti: jdino_m.apply(p, pts, desc, ti), dp,
            lambda p, pts, ti: jshot_m.apply({"params": p["params"]}, pts, fi.shot, fi.normal, ti),
            sp, fi.pc, fi.valid, fi.count, k2, cat, pipe)

    return run(vp, sp, dp, jnp.asarray(rgb, jnp.float32) / 255.0, jnp.asarray(depth), key)


def _draws(key, mask, hw, pipe):
    """The draws dispatch_instance makes from `key`, as arrays."""
    k1, k2 = jax.random.split(key)
    h, w = window_shape(hw, auto_crop(mask))
    perm = np.array(jax.random.permutation(k1, h * w))
    prio = np.array(jax.random.uniform(jax.random.fold_in(k1, 1), (h * w,)))
    k_tuple, k_dino, k_shot = jax.random.split(k2, 3)
    shape = (pipe.num_pairs * 6, pipe.num_bins)
    pose = PoseDraws(torch.from_numpy(np.array(jax.random.uniform(k_tuple, (pipe.num_pairs, 5)))),
                     torch.from_numpy(np.array(jax.random.gumbel(k_dino, shape))),
                     torch.from_numpy(np.array(jax.random.gumbel(k_shot, shape))))
    return tdriver.InstanceDraws(torch.from_numpy(perm), torch.from_numpy(prio), pose)


def _rot_angle_deg(a, b):
    return float(np.degrees(np.arccos(np.clip((np.trace(a.T @ b) - 1) / 2, -1, 1))))


def test_estimate_instance_matches_jax_graph():
    """R within 0.5 deg, T within 2 mm, s rtol 1e-3, the same pick (the
    tolerances of test_torch_pipeline.py: the cloud is exact, the tiny ViT's
    descriptors agree to 2e-3 and the alignment's Adam steps add the rest)."""
    rgb, depth, mask = _frame()
    jvit, vp, jshot_m, sp, jdino_m, dp, tvit, tmodels = _models()
    key = jax.random.key(21)
    want = _jax_instance(rgb, depth, mask, key, jvit, vp, jshot_m, sp, jdino_m, dp, JPipe(**PIPE))
    got = tdriver.estimate_instance(rgb, depth, mask, K, tmodels, "mug", TPipe(**PIPE),
                                    vit=tvit, device="cpu", draws=_draws(key, mask, depth.shape,
                                                                         TPipe(**PIPE)),
                                    stride=STRIDE, out_size=OUT)
    assert _rot_angle_deg(got.rotation.numpy(), np.asarray(want.rotation)) < 0.5
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=2e-3)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-3)
    assert int(got.pick) == int(want.pick)
    np.testing.assert_allclose(float(got.scale_norm), float(want.scale_norm), rtol=1e-3)


def test_estimate_instance_draws_from_generator_and_refuses_missing_cuda():
    """Without injected draws the entry point draws from the generator
    (same seed, same pose); asking for CUDA without a card raises."""
    rgb, depth, mask = _frame()
    _, _, _, _, _, _, tvit, tmodels = _models()
    pipe = TPipe(**PIPE)
    outs = [tdriver.estimate_instance(rgb, depth, mask, K, tmodels, "mug", pipe,
                                      generator=torch.Generator().manual_seed(3), vit=tvit,
                                      device="cpu", stride=STRIDE, out_size=OUT)
            for _ in range(2)]
    torch.testing.assert_close(outs[0].rotation, outs[1].rotation, atol=0, rtol=0)
    r = outs[0].rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    geo = tdriver.estimate_instance(rgb, depth, mask, K, tmodels, "mug", pipe,
                                    generator=torch.Generator().manual_seed(3), vit=None,
                                    device="cpu")
    assert int(geo.pick) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tdriver.estimate_instance(rgb, depth, mask, K, tmodels, "mug", pipe, vit=tvit)
