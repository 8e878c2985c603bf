"""The port's `examples/custom_training.py` against the JAX example on the
CPU, with the helpers and tolerances of test_torch_accuracy.py (its module
docstring): the losses of the same steps, then the held-out frame's pose
R 0.5°, T 2 mm."""

import functools

import jax
import numpy as np

from cppf2_torch.config import CATEGORIES as TCATS
from cppf2_torch.examples import custom_training as tct
from cppf2_torch.models.porting import load_branch
from test_torch_accuracy import _JaxFrames, _jax_frontend, _jax_script, _jax_step_draws, _t, _u


def test_custom_training_run_matches_the_jax_example(monkeypatch):
    """`run` at a tiny size: 6 steps on two 60 x 80 frames of the JAX
    generator (20,000 surface samples), then the held-out frame with the JAX example's draws (keys 7,
    8, 9) and the JAX-trained weights, its frontend held to the JAX one
    (module docstring)."""
    jct = _jax_script("custom_training", "examples")
    monkeypatch.setattr(jct, "SyntheticFrameGenerator",
                        functools.partial(jct.SyntheticFrameGenerator, surface_samples=20000))
    monkeypatch.setattr(tct, "SyntheticFrameGenerator",
                        functools.partial(_JaxFrames, surface_samples=20000))
    _jax_frontend(tct, [jax.random.key(7)], monkeypatch)
    # weights after Adam steps are never compared (a gradient of 1e-9 whose
    # sign differs moves a weight by 2 lr, test_torch_train.py): the
    # held-out pose runs on the JAX-trained weights in both packages
    trained = {}
    pose_branch, branch_pose = jct.estimate_pose_branch, tct._branch_pose

    def keep(fn, params, *a, **k):
        trained["params"] = jax.device_get(params)
        return pose_branch(fn, params, *a, **k)

    monkeypatch.setattr(jct, "estimate_pose_branch", keep)
    monkeypatch.setattr(tct, "_branch_pose",
                        lambda model, *a: branch_pose(load_branch(model, trained["params"]), *a))
    kw = dict(steps=6, n_points=128, tuples_per_step=256, num_pairs=512, pool_frames=2,
              render_hw=(60, 80), progress=lambda *_: None)
    want = jct.run("can", **kw)
    cat = TCATS["can"]

    def test_draws(n_pixels, cat, pipe, device):
        k7 = jax.random.key(7)
        return (_t(jax.random.permutation(k7, n_pixels)), _u(jax.random.fold_in(k7, 1), (n_pixels,)),
                _u(jax.random.key(8), (pipe.num_pairs, cat.tuple_size)),
                _t(jax.random.gumbel(jax.random.key(9), (pipe.num_pairs * 6, pipe.num_bins))))

    got = tct.run("can", device="cpu", step_draws=_jax_step_draws(256, cat.tuple_size),
                  test_draws=test_draws, **kw)
    np.testing.assert_allclose(got["loss_first"], want["loss_first"], rtol=1e-5)
    np.testing.assert_allclose(got["loss_last"], want["loss_last"], rtol=1e-3)
    assert abs(got["rot_err_deg"] - want["rot_err_deg"]) < 0.5
    assert abs(got["trans_err_cm"] - want["trans_err_cm"]) < 0.2
    assert abs(got["scale_err_cm"] - want["scale_err_cm"]) < 0.2
