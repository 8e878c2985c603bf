"""The JAX package on the CPU against the port on the CPU on chosen held-out
frames of `ensemble_benchmark`, for reading a card run against RESULTS.md's
reference table (which the JAX package recorded on a TPU). Not a test: a
command that prints one line per frame.

    JAX_PLATFORMS=cpu python tests/reference_frames.py visibility mug 100
    JAX_PLATFORMS=cpu python tests/reference_frames.py poses can 16 53 98

`visibility CAT N` renders the first N held-out frames of CAT (generator
seed 77, 4096 points) with the JAX generator and prints the handle
visibility of each. `poses CAT I...` renders up to the largest frame and
poses each chosen one with RESULTS.md's reference configuration (ckpts_r3,
the seed-0 ViT-L/14 at stride 8, 4096 points, 20,000 pairs, 3 restarts)
twice: through the JAX script's graph with `jax.random.key(1000 + i)`, and
through the port's frontend and ensemble program on the same frame with
the same draws (`test_torch_accuracy._jax_frame_draws`). About 3 minutes
of set-up (two seeded ViT-Ls) and 10-20 s a frame on an 8-core CPU.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts"), os.path.dirname(os.path.abspath(__file__))]

from cppf2_torch.config import CATEGORIES as TC  # noqa: E402
from cppf2_torch.config import PipelineConfig as TP  # noqa: E402
from cppf2_torch.data import synthetic as tsynth  # noqa: E402
from cppf2_torch.eval.driver import CategoryModels, _frontend  # noqa: E402
from cppf2_torch.eval.pose_errors import fetch_rt_pairs as tfetch  # noqa: E402
from cppf2_torch.eval.pose_errors import pose_error_degree_cm as terr  # noqa: E402
from cppf2_torch.models.dinov2 import DinoFeatureExtractor as TExt  # noqa: E402
from cppf2_torch.scripts import ensemble_benchmark as teb  # noqa: E402
from cppf2_torch.train.driver import _frame_descriptors as tdesc  # noqa: E402
from cppf2_tpu.config import CATEGORIES as JC  # noqa: E402
from cppf2_tpu.config import PipelineConfig as JP  # noqa: E402
from cppf2_tpu.data.synthetic import SyntheticFrameGenerator as JGen  # noqa: E402
from cppf2_tpu.eval.pose_errors import fetch_rt_pairs as jfetch  # noqa: E402
from cppf2_tpu.eval.pose_errors import pose_error_degree_cm as jerr  # noqa: E402
from cppf2_tpu.infer.frontend import preprocess_frame as jpre  # noqa: E402
from cppf2_tpu.infer.pipeline import estimate_pose_ensemble as jens  # noqa: E402
from cppf2_tpu.models import DinoBranch as JDino  # noqa: E402
from cppf2_tpu.models.dinov2 import DinoFeatureExtractor as JExt  # noqa: E402
from cppf2_tpu.train.checkpoints import load_params_msgpack as jload  # noqa: E402
from cppf2_tpu.train.driver import _frame_descriptors as jdesc  # noqa: E402

N_POINTS, PAIRS, RESTARTS = 4096, 20000, 3


def visibility(cat, n):
    gen = JGen(JC[cat], n_max=N_POINTS, shot_k=48, seed=77)
    for i in range(n):
        gen.next_frame()
        print(f"{cat} frame {i}: handle visible {gen.last_handle_visible}", flush=True)


def poses(cat, frames):
    import ensemble_benchmark as jeb
    from test_torch_accuracy import _jax_frame_draws

    t0 = time.time()
    ckpts = os.path.join(ROOT, "ckpts_r3")
    jp = JP(n_points=N_POINTS, num_pairs=PAIRS, restarts=RESTARTS)
    tp = TP(n_points=N_POINTS, num_pairs=PAIRS, restarts=RESTARTS)
    jext = JExt(stride=8)
    jext.init_random(hw=(256, 256), seed=0)
    text = TExt(stride=8, device="cpu").init_random(hw=(256, 256), seed=0)
    shot_model, shot_p = jeb.load_shot_params(ckpts, cat, JC[cat])
    dino_model = JDino(tuple_size=JC[cat].tuple_size)
    ref = dino_model.init(jax.random.key(1), jnp.zeros((16, 3)), jnp.zeros((16, 1024)),
                          jnp.zeros((8, JC[cat].tuple_size), jnp.int32))
    dino_p = jload(os.path.join(ckpts, "dino", cat, "params.msgpack"), ref)
    models = CategoryModels(teb.load_shot_params(ckpts, cat, TC[cat], "cpu"),
                            teb._load_branch(teb.DinoBranch(tuple_size=TC[cat].tuple_size),
                                             os.path.join(ckpts, "dino", cat, "params.msgpack"),
                                             "cpu"))
    tpose = models.pose_fn(TC[cat], tp, True)
    draws = _jax_frame_draws(tp, TC[cat].tuple_size)
    gen = JGen(JC[cat], n_max=N_POINTS, shot_k=48, seed=77)
    pre = jax.jit(lambda d, k: jpre(d, d > 0, gen.intrinsics, k, res=JC[cat].res, n_max=N_POINTS,
                                    shot_k=48))

    @jax.jit
    def jpose(dp, sp, fi, desc, key):
        return jens(lambda p, pts, ti: dino_model.apply(p, pts, desc, ti), dp,
                    lambda p, pts, ti: shot_model.apply(p, pts, fi.shot, fi.normal, ti), sp,
                    fi.pc, fi.valid, fi.count, key, JC[cat], jp, run_opt=True)

    for i in range(max(frames) + 1):
        f = gen.next_frame()
        if i not in frames:
            continue
        vis = gen.last_handle_visible
        key = jax.random.key(1000 + i)
        fi = pre(f.depth, key)
        desc = jnp.asarray(jdesc(f._replace(pixel_yx=fi.pixel_yx), jext))
        est = jpose(dino_p, shot_p, fi, desc, jax.random.fold_in(key, 1))
        (rt, _, gt, _, pick), = jfetch([est], f, extras_per_est=[(est.pick,)])
        tf = tsynth.SynthFrame(*(torch.from_numpy(np.array(x)) for x in f))
        perm, prio, pose = draws(i, tf.depth.numel())
        with torch.no_grad():
            tfi = _frontend(tf.depth, tf.depth > 0, torch.from_numpy(np.array(gen.intrinsics)), perm,
                            prio, None, TC[cat].res, N_POINTS, 48, None)
            d = tdesc(tf._replace(pixel_yx=tfi.pixel_yx), text)
            te = tpose(tfi.pc, tfi.valid, tfi.count, d, tfi.shot, tfi.normal, pose)
            (trt, _, tgt, _, tpick), = tfetch([te], tf, extras_per_est=[(te.pick,)])
        je = jerr(rt, gt, cat, handle_visibility=vis)
        pe = terr(trt, tgt, cat, handle_visibility=vis)
        print(f"{cat} frame {i}: JAX CPU {je[0]:.2f} deg {je[1]:.2f} cm pick {int(pick)} | port CPU, "
              f"the same draws, {pe[0]:.2f} deg {pe[1]:.2f} cm pick {int(tpick)} | handle visible "
              f"{vis} | {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    what, cat, *rest = sys.argv[1:]
    if what == "visibility":
        visibility(cat, int(rest[0]))
    else:
        poses(cat, [int(x) for x in rest])
