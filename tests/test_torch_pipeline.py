"""`estimate_pose_ensemble` against the JAX pose graph with the reference's
own draws: n 512 points, 2,000 pairs, 5-degree sphere, 100 Adam steps,
both branches (f32, the shipped mug weights), all three arbiters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.config import CATEGORIES as T_CATEGORIES
from cppf2_torch.config import PipelineConfig as TPipe
from cppf2_torch.infer.pipeline import PoseDraws, estimate_pose_ensemble as t_ensemble
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import DinoBranch as TDino
from cppf2_torch.models.cppf import ShotBranch as TShot
from cppf2_torch.models.porting import load_branch
from cppf2_tpu.config import CATEGORIES as J_CATEGORIES
from cppf2_tpu.config import PipelineConfig as JPipe
from cppf2_tpu.infer.frontend import preprocess_frame
from cppf2_tpu.infer.pipeline import estimate_pose_ensemble as j_ensemble
from cppf2_tpu.models import DinoBranch as JDino
from cppf2_tpu.models import ShotBranch as JShot

K = np.array([[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084], [0.0, 0.0, 1.0]], np.float32)
PIPE = dict(n_points=512, num_pairs=2000, angle_tol_deg=5.0)


def _frame(h=120, w=160, radius=0.06, center=(0.0, 0.0, 0.6)):
    """The bench's sphere-cap object, shrunk to a 120x160 frame."""
    rng = np.random.default_rng(0)
    cx, cy, cz = center
    fx, fy = K[0, 0], K[1, 1]
    uu = 80 - fx * cx / cz
    vv = 60 - fy * cy / cz
    ys, xs = np.mgrid[0:h, 0:w]
    rpix = radius * fx / cz
    d2 = (xs - uu) ** 2 + (ys - vv) ** 2
    mask = d2 < rpix ** 2
    bump = np.sqrt(np.maximum(radius ** 2 - d2 * (cz / fx) ** 2, 0.0))
    depth = np.where(mask, cz - bump + rng.normal(0, 3e-4, (h, w)), 0.0).astype(np.float32)
    return depth, mask


def _features():
    depth, mask = _frame()
    k = K.copy()
    k[0, 2], k[1, 2] = 80.0, 60.0
    fi = preprocess_frame(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(k), jax.random.key(9),
                          res=2e-3, n_max=512, shot_k=24)
    desc = np.random.default_rng(1).normal(size=(512, 1024)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return fi, desc


def jax_pose_draws(key, pipe, tuple_size):
    """The draws estimate_pose_ensemble makes from `key`, as arrays."""
    k_tuple, k_dino, k_shot = jax.random.split(key, 3)
    shape = (pipe.num_pairs * 6, pipe.num_bins)
    return PoseDraws(
        torch.from_numpy(np.array(jax.random.uniform(k_tuple, (pipe.num_pairs, tuple_size)))),
        torch.from_numpy(np.array(jax.random.gumbel(k_dino, shape))),
        torch.from_numpy(np.array(jax.random.gumbel(k_shot, shape))))


def _models():
    shot_p = load_params_msgpack("ckpts_r3/shot/mug/params.msgpack")
    dino_p = load_params_msgpack("ckpts_r3/dino/mug/params.msgpack")
    return (JShot(), shot_p, JDino(), dino_p,
            load_branch(TShot(), shot_p), load_branch(TDino(), dino_p))


def _rot_angle_deg(a, b):
    c = (np.trace(a.T @ b) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.mark.parametrize("restarts,arbiter,run_opt",
                         [(1, "margin", True), (2, "cross", True), (1, "recon", False)])
def test_estimate_pose_ensemble(restarts, arbiter, run_opt):
    """Without the alignment the voted pose agrees to the last ulp: the same
    bins, histogram peaks and sphere points; R and T differ by at most an
    ulp or two (atol 1e-7, rtol 2.4e-7), as XLA fuses the peak-center and
    Gram-Schmidt arithmetic into multiply-adds. The 100 Adam steps on the
    L1 loss amplify float32 noise near the optimum (tests/test_torch_voting
    .py::test_align_pose), so with them: R within 0.5 deg (0.19 and 0.32
    measured), T within 2 mm, s rtol 1e-3, the same pick, loss rtol 0.05."""
    cat_name = "mug"
    jpipe = JPipe(**PIPE, restarts=restarts, arbiter=arbiter)
    tpipe = TPipe(**PIPE, restarts=restarts, arbiter=arbiter)
    fi, desc = _features()
    jshot_m, shot_p, jdino_m, dino_p, tshot_m, tdino_m = _models()
    key = jax.random.key(11)

    @jax.jit
    def run(sp, dp, pc, valid, count, shot, normal, desc, key):
        return j_ensemble(
            lambda p, pts, ti: jdino_m.apply({"params": p["params"]}, pts, desc, ti), dp,
            lambda p, pts, ti: jshot_m.apply({"params": p["params"]}, pts, shot, normal, ti), sp,
            pc, valid, count, key, J_CATEGORIES[cat_name], jpipe, run_opt=run_opt)

    want = run(shot_p, dino_p, fi.pc, fi.valid, fi.count, fi.shot, fi.normal, desc, key)

    keys = jax.random.split(key, restarts) if restarts > 1 else [key]
    draws = [jax_pose_draws(k, jpipe, 5) for k in keys]
    pc, valid, shot, normal = (torch.from_numpy(np.array(x)) for x in
                               (fi.pc, fi.valid, fi.shot, fi.normal))
    desc_t = torch.from_numpy(desc)
    with torch.no_grad():
        got = t_ensemble(lambda pts, ti: tdino_m(pts, desc_t, ti),
                         lambda pts, ti: tshot_m(pts, shot, normal, ti),
                         pc, valid, torch.tensor(int(fi.count)), T_CATEGORIES[cat_name], tpipe,
                         draws=draws if restarts > 1 else draws[0], run_opt=run_opt)
    if not run_opt:
        np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-7)
        np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation),
                                   rtol=2.4e-7, atol=0)
    assert _rot_angle_deg(got.rotation.numpy(), np.asarray(want.rotation)) < 0.5
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=2e-3)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-3)
    assert int(got.pick) == int(want.pick)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=0.05)
