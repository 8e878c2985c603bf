"""The port's accuracy studies against the JAX package's scripts on the CPU:
`scripts/config_validation.py` (`eval_config`), `budget_study.py` (the
occupancy count and the report), `dtype_check.py` (the two models of one
msgpack) and `ablation_analysis.py` (its printed output), each imported
from `scripts/` as test_torch_accuracy.py imports the JAX scripts.

Both packages pose the same frames: the port's generator's, 120 x 160 with
20,000 surface samples (the JAX generator's to 1e-5, test_torch_data.py),
at `PipelineConfig(n_points=256, num_pairs=512)`, with the JAX script's
`jax.random` draws. As in test_torch_accuracy.py (its module docstring), the
port's frontend is held to the JAX one on the cloud exactly, and both pose
graphs then take the JAX features: here the ones the JAX script's own
jitted program computed, read out of it by a debug callback, so that the
JAX side compiles each configuration once. Tolerances: the cloud, counts,
5°5cm rates and the printed text exact; the aligned pose R 0.5°, T 2 mm;
the branch forwards those of test_torch_models.py.
"""

import contextlib
import functools
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.config import CATEGORIES as TCATS
from cppf2_torch.config import PipelineConfig as TPipe
from cppf2_torch.core.downsample import draw_downsample
from cppf2_torch.eval import programs
from cppf2_torch.data import synthetic as tsynth
from cppf2_torch.infer import alignment as talign
from cppf2_torch.infer.pipeline import BranchDraws
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.scripts import ablation_analysis as tab
from cppf2_torch.scripts import budget_study as tbs
from cppf2_torch.scripts import config_validation as tcv
from cppf2_torch.scripts import synthetic_benchmark as tsb
from cppf2_tpu.config import CATEGORIES as JCATS
from cppf2_tpu.config import PipelineConfig as JPipe
from cppf2_tpu.core.downsample import voxel_downsample as jvoxel_downsample
from cppf2_tpu.core.geometry import backproject_masked as jbackproject_masked
from cppf2_tpu.data import synthetic as jsynth
from cppf2_tpu.models import ShotBranch as JShot
from test_torch_accuracy import ROOT, SMALL_FRAMES, _jax_script, _rot_deg, _t, _u
from test_torch_programs import _HostReads

CAT = "can"
CKPT = os.path.join(ROOT, "ckpts_r2", "shot", CAT, "params.msgpack")
YAW_NPZ = os.path.join(ROOT, "benchmarks", "r4_yaw_mug", "errors_mug.npz")


def _port_frames(n, **kw):
    """The port generator's first `n` frames of `CAT` at the tests' size."""
    gen = tsynth.SyntheticFrameGenerator(TCATS[CAT], n_max=256, shot_k=tsb.SHOT_K, device="cpu",
                                         **SMALL_FRAMES, **kw)
    return gen, [gen.next_frame() for _ in range(n)]


def _as_jax_frame(f):
    return jsynth.SynthFrame(*(x.numpy() for x in f))


def _jax_study_draws(pipe, tuple_size, base=1000):
    """The JAX studies' draws of frame i: key(base + i) for the voxels,
    split(fold_in(key, 1)) into the tuple uniforms and the bin samples'
    Gumbel noise."""
    def draws(i, n_pixels):
        key = jax.random.key(base + i)
        k1, k2 = jax.random.split(jax.random.fold_in(key, 1))
        bd = BranchDraws(_u(k1, (pipe.num_pairs, tuple_size)),
                         _t(jax.random.gumbel(k2, (pipe.num_pairs * 6, pipe.num_bins))))
        return (_t(jax.random.permutation(key, n_pixels)),
                _u(jax.random.fold_in(key, 1), (n_pixels,)), [bd])
    return draws


def _recorded_rts(module, monkeypatch):
    """Every rt `module.fetch_rt_pair` returns, in call order."""
    rts, fetch = [], module.fetch_rt_pair

    def recording(est, frame):
        out = fetch(est, frame)
        rts.append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(module, "fetch_rt_pair", recording)
    return rts


@pytest.mark.parametrize("exact_knn,dtype", [(False, "float32"), (False, "bfloat16"),
                                             (True, "float32")])
def test_eval_config_matches_the_jax_script(exact_knn, dtype, monkeypatch):
    """Two held-out can frames through both scripts' `eval_config` with the
    ckpts_r2 SHOT branch (the port's model of `dtype` from `shot_models`):
    the JAX program's cloud equals the port frontend's, and with its
    features both pose graphs give the same pose, R 0.5°, T 2 mm, and the
    same 5°5cm rate. Both kNN routes are held, and both dtypes."""
    jcv = _jax_script("config_validation")
    for mod in (jcv, tcv):
        monkeypatch.setattr(mod, "SyntheticFrameGenerator",
                            functools.partial(mod.SyntheticFrameGenerator, **SMALL_FRAMES))
    _, frames = _port_frames(2, seed=77)
    tree = load_params_msgpack(CKPT)

    # the features the JAX program computes, read out by a debug callback
    jax_fis, preprocess = [], jcv.preprocess_frame

    def spy(*a, **k):
        fi = preprocess(*a, **k)
        jax.debug.callback(lambda *xs: jax_fis.append([np.asarray(x) for x in xs]), fi.pc,
                           fi.valid, fi.count, fi.pixel_yx, fi.shot, fi.normal)
        return fi

    monkeypatch.setattr(jcv, "preprocess_frame", spy)
    want_rts = _recorded_rts(jcv, monkeypatch)
    jpipe = JPipe(n_points=256, num_pairs=512)
    want = jcv.eval_config(CAT, tree, [_as_jax_frame(f) for f in frames], jpipe, 256, 0, exact_knn,
                           dtype)
    jax.effects_barrier()
    assert len(jax_fis) == len(frames)

    port_frontend, fis = tsb._frontend, iter(jax_fis)

    def frontend(*a, exact_knn=False):
        got = port_frontend(*a, exact_knn=exact_knn)
        pc, valid, count, pixel_yx, shot, normal = next(fis)
        for name, w in (("pc", pc), ("valid", valid), ("count", count), ("pixel_yx", pixel_yx)):
            np.testing.assert_array_equal(getattr(got, name).numpy(), w, err_msg=name)
        return got._replace(shot=_t(shot), normal=_t(normal))

    monkeypatch.setattr(tsb, "_frontend", frontend)
    got_rts = _recorded_rts(tsb, monkeypatch)
    tpipe = TPipe(n_points=256, num_pairs=512)
    model = tcv.shot_models(CKPT, TCATS[CAT], "cpu")[dtype]
    got = tcv.eval_config(CAT, model, frames, tpipe, 256, 0, exact_knn, "cpu",
                          draws=_jax_study_draws(tpipe, TCATS[CAT].tuple_size))
    assert len(got_rts) == len(want_rts) == len(frames)
    for g, w in zip(got_rts, want_rts):
        assert _rot_deg(g, w) < 0.5
        assert np.abs(g[:3, 3] - w[:3, 3]).max() < 2e-3
    assert sorted(got) == sorted(want)
    assert got["deg5cm5"] == want["deg5cm5"]
    assert abs(got["median_cm"] - want["median_cm"]) < 0.2


def test_budget_study_occupancy_is_the_jax_count(monkeypatch, tmp_path):
    """`budget_study.main` on two close-range can frames at budgets 256 and
    512: the occupied voxels of each frame equal the JAX script's
    `occupancy` (its jitted body, copied: the script defines it inside
    `main`), so do the report's median, max and kept fractions, and the
    report has the recorded JAX report's keys."""
    monkeypatch.setattr(tbs, "SyntheticFrameGenerator",
                        functools.partial(tbs.SyntheticFrameGenerator, **SMALL_FRAMES))
    out = tmp_path / "budget.json"
    report = tbs.main(["--category", CAT, "--frames", "2", "--budgets", "256", "512",
                       "--num-pairs", "512", "--ckpts", os.path.join(ROOT, "ckpts"), "--out",
                       str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == report

    gen, frames = _port_frames(2, seed=77, z_range=(0.6, 0.9))
    k = jnp.asarray(gen.intrinsics_np)
    res = JCATS[CAT].res

    @jax.jit
    def occupancy(depth):
        pts, _, valid = jbackproject_masked(depth, k, depth > 0)
        ds = jvoxel_downsample(pts, valid, res, 65536, jax.random.key(0))
        return ds.count

    want = np.asarray([int(occupancy(jnp.asarray(f.depth.numpy()))) for f in frames])
    got = np.asarray([int(tbs.occupancy(f.depth, gen.intrinsics, TCATS[CAT].res)) for f in frames])
    np.testing.assert_array_equal(got, want)
    assert want.min() > 512   # every frame overflows both budgets
    assert report["median_occupied_voxels"] == int(np.median(want))
    assert report["max_occupied_voxels"] == int(want.max())
    for budget, row in report["budgets"].items():
        kept = np.minimum(want, int(budget)) / np.maximum(want, 1)
        assert row["mean_kept_fraction"] == float(kept.mean())

    with open(os.path.join(ROOT, "benchmarks", "budget_study.json")) as f:
        recorded = json.load(f)
    assert sorted(report) == sorted(recorded)
    assert list(report["budgets"]) == ["256", "512"]
    assert {tuple(sorted(r)) for r in report["budgets"].values()} == \
        {tuple(sorted(r)) for r in recorded["budgets"].values()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_check_models_match_jax(dtype):
    """dtype_check's two models, both from the one ckpts_r2 msgpack: one
    forward each against the JAX ShotBranch of that dtype on the same
    params, at test_torch_models.py's tolerances (f32 5e-6 of the largest
    output; bf16 0.02 of it, the mean error under 0.002). The inputs are
    what dtype_check feeds the models: a rendered frame's (generator seed
    123) cloud, SHOT rows and normals from the port's frontend, and tuples
    over its points. (On test_torch_models.py's random inputs, far from
    the trained range, a bf16 flip grows to 6 ulps on 2 of the scale
    head's 150 outputs in one package against the other.)"""
    gen, (frame,) = _port_frames(1, seed=123)
    g = torch.Generator().manual_seed(500)
    perm, prio = draw_downsample(frame.depth.numel(), "cpu", g)
    fi = tsb._frontend(frame.depth, frame.depth > 0, gen.intrinsics, perm, prio, None,
                       TCATS[CAT].res, 256, tsb.SHOT_K, None)
    size = TCATS[CAT].tuple_size
    ti = np.random.default_rng(5).integers(0, int(fi.count), size=(512, size)).astype(np.int32)
    inputs = (fi.pc.numpy(), fi.shot.numpy(), fi.normal.numpy(), ti)
    models = tcv.shot_models(CKPT, TCATS[CAT], "cpu")
    assert sorted(models) == ["bfloat16", "float32"]
    assert all(p.dtype == torch.float32 for m in models.values() for p in m.parameters())
    with torch.no_grad():
        got = models[dtype](*(torch.from_numpy(x) for x in inputs))
    want = JShot(tuple_size=size, dtype=dtype).apply(load_params_msgpack(CKPT), *inputs)
    for g, w in ((got.logits, want.logits), (got.scales, want.scales)):
        g, w = g.numpy(), np.asarray(w)
        scale = float(np.abs(w).max())
        assert g.dtype == np.float32 and g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=5e-6 * scale, rtol=0)
        else:
            np.testing.assert_allclose(g, w, atol=0.02 * scale, rtol=0)
            assert np.mean(np.abs(g - w)) < 0.002 * scale


def test_recorded_counts_the_programs_of_a_block():
    """`programs.recorded`, which the studies and chip_smoke.py count their
    programs with: each block (nested blocks too) holds the programs called
    inside, with their replays and eager runs when first called there, so a
    program an earlier block ran counts only its runs since; a block's
    record leaves with it, whichever blocks hold equal records."""
    cache, x = {}, torch.ones(3)

    def call():
        return programs.program(cache, ("double",), lambda t: 2 * t, (x,))(x)

    call()
    with programs.recorded() as outer:
        with programs.recorded() as inner:
            call()
        call()
    assert programs._recorders == []
    (prog, replays, eager, made), = outer.values()
    assert list(inner.values()) == list(outer.values())
    assert (replays, eager, made, prog.eager_runs) == (0, 1, True, 3)
    assert prog.eager_runs - eager == 2   # eager on the CPU: the block's two calls


def test_yaw_sweep_makes_no_host_reads():
    """The yaw sweep, which the ablation's treatment (`--compare
    yaw_sweep=True`) runs inside its ensemble program: no operator reads the
    device back or builds a tensor from host values (a list index or a
    scalar written into a slice is one, and the card's capture refuses it),
    on a single row and on rows, and the rotations are those of the rows
    one by one."""
    rng = np.random.default_rng(2)
    b, n, k = 3, 64, 40
    args = (torch.from_numpy((rng.normal(size=(b, n, 3)) * 0.05).astype(np.float32)),
            torch.from_numpy(rng.integers(0, n, size=(b, k, 2))),
            torch.from_numpy(rng.uniform(size=(b, k)).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(b, k, 2, 3)) * 0.05).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(b, k, 2, 3)).astype(np.float32)),
            torch.eye(3).expand(b, 3, 3).contiguous(), torch.zeros(b, 3))
    talign.yaw_sweep(*args, 1)   # the sweep's constants are made once a device, outside
    for rows in (args, tuple(a[0] for a in args)):
        mode = _HostReads()
        with mode:
            got = talign.yaw_sweep(*rows, 1)
        assert not mode.seen, mode.seen
    for i in range(b):
        np.testing.assert_array_equal(talign.yaw_sweep(*(a[i] for a in args), 1).numpy(),
                                      talign.yaw_sweep(*args, 1)[i].numpy())
    assert got.shape == (3, 3)


def _printed(main, argv, monkeypatch):
    """What `main` prints, called with `argv` (the JAX script reads sys.argv)."""
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["ablation_analysis.py"] + argv)
    with contextlib.redirect_stdout(buf):
        main()
    return buf.getvalue()


def _paired_npz(path, handle_visible=True):
    """An npz shaped like an ensemble_benchmark --compare run's, whose two
    variants part on some frames (the recorded yaw npz's do not)."""
    rng = np.random.default_rng(3)
    base = np.stack([rng.gamma(2.0, 3.0, 40), rng.gamma(2.0, 1.5, 40)], axis=1)
    moved = base * rng.choice([0.3, 1.0, 1.0, 4.0], size=(40, 1))
    arrays = {"errs": base, "picks": np.ones(40, np.int64),
              "errs__arbiter_margin": moved, "picks__arbiter_margin": np.ones(40, np.int64),
              "errs__arbiter_recon": base, "picks__arbiter_recon": np.zeros(40, np.int64)}
    if handle_visible:
        arrays["handle_visible"] = rng.integers(0, 2, 40)
    np.savez(path, **arrays)
    return str(path)


@pytest.mark.parametrize("case", ["yaw", "yaw_swapped", "paired", "paired_no_handles"])
def test_ablation_analysis_prints_the_jax_scripts_text(case, monkeypatch, tmp_path):
    """The port's `ablation_analysis` prints the JAX script's text, character
    for character: the recorded round-4 mug yaw npz in its insertion order
    and with --a / --b swapped, and a paired npz whose variants part (with
    and without handle visibility)."""
    jab = _jax_script("ablation_analysis")
    argv = {"yaw": [YAW_NPZ],
            "yaw_swapped": [YAW_NPZ, "--a", "yaw_sweep_False", "--b", "yaw_sweep_True"],
            "paired": [_paired_npz(tmp_path / "p.npz")],
            "paired_no_handles": [_paired_npz(tmp_path / "q.npz", handle_visible=False)]}[case]
    want = _printed(jab.main, argv, monkeypatch)
    got = _printed(lambda: tab.main(argv), argv, monkeypatch)
    assert got == want
    assert got.startswith("treatment ")
    if case.startswith("paired"):
        assert "fixed frames (control -> treatment):" in got


def test_ablation_analysis_exits_without_variants(monkeypatch, tmp_path):
    """A single-variant npz: both scripts raise the same SystemExit."""
    jab = _jax_script("ablation_analysis")
    path = str(tmp_path / "single.npz")
    np.savez(path, errs=np.zeros((3, 2)), picks=np.zeros(3), handle_visible=np.ones(3))
    monkeypatch.setattr(sys, "argv", ["ablation_analysis.py", path])
    with pytest.raises(SystemExit) as want:
        jab.main()
    with pytest.raises(SystemExit) as got:
        tab.main([path])
    assert str(got.value) == str(want.value)
    assert "no per-variant arrays" in str(got.value)
