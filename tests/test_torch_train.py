"""The port's trainer against the JAX package on the CPU: the tuple loss, one
step's loss and gradients, AdamW with the step schedule on injected
gradients, the loss curve over a few steps, a two-rank step against the
one-rank step, checkpoints, and the msgpack and backbone files each package
writes for the other.

Parameters after several Adam steps are never compared: at step 1 the update
is lr * g / (|g| + eps), so a gradient of 1e-9 whose sign differs between the
two packages moves a parameter by 2 lr. Ranks are gloo subprocesses
(test_torch_parallel.run_ranks) that never import JAX; weights reach them as
flax msgpack files, arrays as .npz.
"""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cppf2_torch.config import TrainConfig as TCfg
from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models.checkpoints import dumps_msgpack, load_params_msgpack, loads_msgpack
from cppf2_torch.models.cppf import DinoBranch as TDino
from cppf2_torch.models.cppf import ShotBranch as TShot
from cppf2_torch.models.cppf import TuplePredictions
from cppf2_torch.models.porting import (
    branch_to_tree,
    load_branch,
    load_train_state,
    load_vit,
    vit_to_tree,
)
from cppf2_torch.ops import attention
from cppf2_torch.train import checkpoints as tckpt
from cppf2_torch.train import loop as tloop
from cppf2_torch.train import visual as tvisual
from cppf2_torch.data.synthetic import SynthFrame
from cppf2_torch.train import driver as tdriver
from cppf2_torch.train.driver import train_category
from cppf2_tpu.config import TrainConfig as JCfg
from cppf2_tpu.data.records import RecordWriter as JRecordWriter
from cppf2_tpu.models import DinoBranch as JDino
from cppf2_tpu.models import ShotBranch as JShot
from cppf2_tpu.models import dinov2 as jdino
from cppf2_tpu.models.cppf import TuplePredictions as JPreds
from cppf2_tpu.config import CATEGORIES as JCATS
from cppf2_tpu.data import synthetic as jsynth
from cppf2_tpu.train import checkpoints as jckpt
from cppf2_tpu.train import driver as jdriver
from cppf2_tpu.train import loop as jloop
from cppf2_tpu.train import visual as jvisual
from test_torch_parallel import run_ranks

N, B, TUPLES, STEPS = 128, 2, 256, 5
CFG = dict(tuples_per_step=TUPLES, n_points=N, lr_step_epochs=1, steps_per_epoch=3)
VIT = dict(embed_dim=128, depth=2, num_heads=2, pretrain_grid=4, layerscale_init=1.0)
OUT, STRIDE = 32, 8


def _batch(branch, seed=0):
    rng = np.random.default_rng(seed)
    pc = (0.1 * rng.normal(size=(B, N, 3))).astype(np.float32)
    out = {"pc": pc, "pc_canon": np.clip(pc / 0.35, -0.6, 0.6).astype(np.float32),
           "bound": rng.uniform(0.1, 0.3, (B, 3)).astype(np.float32),
           "count": np.array([N - 9, N - 40], np.int32)}
    if branch == "shot":
        nrm = rng.normal(size=(B, N, 3))
        out["shot"] = rng.uniform(0, 0.3, (B, N, 352)).astype(np.float32)
        out["normal"] = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    elif branch == "dino":
        d = rng.normal(size=(B, N, 64))
        out["desc"] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    else:
        out["crop"] = rng.uniform(size=(B, OUT, OUT, 3)).astype(np.float32)
        out["kp"] = rng.uniform(2, OUT - 2, (B, N, 2)).astype(np.float32)
    return out


def _uniforms(steps):
    """The uniforms the JAX step draws from key(100 + s), and those keys."""
    keys = [jax.random.key(100 + s) for s in range(steps)]
    u = np.stack([np.stack([np.asarray(jax.random.uniform(k, (TUPLES, 5)))
                            for k in jax.random.split(key, B)]) for key in keys])
    return keys, u


def _jax_setup(branch, compute_dtype="float32"):
    """(cfg, init params, jitted train step, batch loss) of the JAX package."""
    cfg = JCfg(**CFG)
    i0 = jnp.zeros((8, 5), jnp.int32)
    if branch == "shot":
        model = JShot()
        params = model.init(jax.random.key(0), jnp.zeros((16, 3)), jnp.zeros((16, 352)),
                            jnp.zeros((16, 3)), i0)
    elif branch == "dino":
        model = JDino()
        params = model.init(jax.random.key(0), jnp.zeros((16, 3)), jnp.zeros((16, 64)), i0)
    if branch != "dino-e2e":
        step = jloop.make_train_step(model, cfg, branch)

        def frame_loss(p, frame, key):
            ti = jloop._sample_tuples(key, frame["count"], TUPLES, 5)
            feats = (frame["shot"], frame["normal"]) if branch == "shot" else (frame["desc"],)
            return jloop.tuple_loss(model.apply(p, frame["pc"], *feats, ti), frame["pc_canon"], ti,
                                    frame["bound"], cfg.num_bins)
    else:
        vit = jdino.DinoViT(jdino.ViTConfig(**VIT, compute_dtype=compute_dtype, attn_impl="hbm"))
        model = JDino()
        params = jvisual.create_visual_train_state(vit, model, cfg, jax.random.key(0), OUT,
                                                   STRIDE).params
        step = jvisual.make_visual_train_step(vit, model, cfg, OUT, STRIDE)

        def frame_loss(p, frame, key):
            resized = jax.image.resize(frame["crop"], (56, 56, 3), method="bilinear")
            desc = jdino.interpolate_features(vit.apply(p["backbone"], resized), frame["kp"],
                                              (OUT, OUT), STRIDE)
            ti = jloop._sample_tuples(key, frame["count"], TUPLES, 5)
            return jloop.tuple_loss(model.apply(p["branch"], frame["pc"], desc, ti),
                                    frame["pc_canon"], ti, frame["bound"], cfg.num_bins)

    def batch_loss(p, batch, key):
        losses = jax.vmap(lambda f, k: frame_loss(p, f, k))(batch, jax.random.split(key, B))
        return jnp.mean(losses["total"])

    return cfg, jax.device_get(params), step, jax.jit(jax.value_and_grad(batch_loss))


# what a rank does: `STEPS` train steps from the given weights on the given
# batch and uniforms; it saves each step's metrics and the averaged gradients
# the first step applied, as a flax-layout tree
_RANK_BODY = """
import copy
from cppf2_torch.config import TrainConfig
from cppf2_torch.models import dinov2
from cppf2_torch.models.checkpoints import dumps_msgpack, load_params_msgpack
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.porting import load_tree, module_to_tree
from cppf2_torch.parallel import make_mesh
from cppf2_torch import train
branch, steps, dtype = {branch!r}, {steps}, {dtype!r}
x = np.load(TMP + "/in.npz")
cfg = TrainConfig(**{cfg!r})
mesh = make_mesh(device="cpu")
tree = load_params_msgpack(TMP + "/params.msgpack")
if branch == "shot":
    model = load_tree(ShotBranch(), tree)
elif branch == "dino":
    model = load_tree(DinoBranch(desc_dim=64), tree)
if branch == "dino-e2e":
    vit = dinov2.DinoViT(dinov2.ViTConfig(**{vit!r}, compute_dtype=dtype, attn_impl="hbm"))
    head = DinoBranch(desc_dim=128)
    state = train.create_visual_train_state(vit, head, cfg, device="cpu")
    load_tree(state.module, tree)
    step = train.make_visual_train_step(vit, head, cfg, {out}, {stride}, mesh=mesh)
else:
    state = train.create_train_state(model, cfg, device="cpu")
    step = train.make_train_step(model, cfg, branch, mesh)
batch = {{k: x[k] for k in x.files if k != "u"}}
metrics = []
for s in range(steps):
    state, m = step(state, batch, tuple_u=torch.from_numpy(x["u"][s]))
    metrics.append([float(m[k]) for k in ("cls", "scale", "total")])
    if s == 0:
        grads = copy.deepcopy(state.module)
        with torch.no_grad():
            for g, p in zip(grads.parameters(), state.module.parameters()):
                g.copy_(p.grad)
        grads = module_to_tree(grads)
assert state.step == steps and state.scheduler.last_epoch == steps
if RANK == 0:
    np.save(TMP + "/metrics%d.npy" % WORLD, np.array(metrics))
    open(TMP + "/grads%d.msgpack" % WORLD, "wb").write(dumps_msgpack(grads))
"""


def _run_port(world, branch, tmp_path, params, batch, u, steps, dtype="float32"):
    with open(tmp_path / "params.msgpack", "wb") as f:
        f.write(flax.serialization.msgpack_serialize(params))
    np.savez(tmp_path / "in.npz", u=u, **batch)
    run_ranks(world, _RANK_BODY.format(branch=branch, steps=steps, dtype=dtype, cfg=CFG, vit=VIT,
                                       out=OUT, stride=STRIDE), tmp_path)
    return (np.load(tmp_path / f"metrics{world}.npy"),
            load_params_msgpack(str(tmp_path / f"grads{world}.msgpack")))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k])


def _assert_trees_close(got, want, rel, atol=0.0):
    """Each leaf within `atol` + `rel` of the wanted leaf's largest magnitude."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        tol = atol + rel * float(np.abs(w).max())
        assert got[name].shape == w.shape, name
        err = float(np.abs(got[name] - w).max())
        assert err <= tol, (name, err, tol)


def test_tuple_loss_matches_jax():
    """rtol 1e-5 on each term; F.kl_div would differ (no epsilon in its log)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 6, 32)).astype(np.float32) * 3
    scales = rng.uniform(0, 0.4, (64, 3)).astype(np.float32)
    canon = rng.uniform(-0.7, 0.7, (50, 3)).astype(np.float32)
    canon[:4] = [[0.5, -0.5, 0.0], [0.5, 0.5, 0.5], [-0.5, -0.5, -0.5], [1 / 31 - 0.5, 0, 0.25]]
    ti = rng.integers(0, 50, (64, 5))
    bound = rng.uniform(0.1, 0.3, 3).astype(np.float32)
    want = jloop.tuple_loss(JPreds(jnp.asarray(logits), jnp.asarray(scales)), jnp.asarray(canon),
                            jnp.asarray(ti), jnp.asarray(bound), 32)
    got = tloop.tuple_loss(TuplePredictions(torch.from_numpy(logits), torch.from_numpy(scales)),
                           torch.from_numpy(canon), torch.from_numpy(ti), torch.from_numpy(bound), 32)
    for k in ("cls", "scale", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_lr_schedule_matches_jax_at_the_boundary():
    cfg = dict(lr=3e-3, lr_gamma=0.3, lr_step_epochs=2, steps_per_epoch=3)
    js, ts = jloop.make_lr_schedule(JCfg(**cfg)), tloop.make_lr_schedule(TCfg(**cfg))
    for step in (0, 5, 6, 7, 11, 12, 100):
        np.testing.assert_allclose(ts(step), float(js(jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_and_schedule_on_injected_gradients(weight_decay):
    """Four updates across the lr boundary (after update 2) on the same
    gradients: parameters within 1e-6 after each. Then optax's moments after
    two updates go into a fresh torch optimizer (`load_train_state`) and the
    third update agrees as well."""
    cfg = dict(lr=1e-2, lr_gamma=0.5, lr_step_epochs=1, steps_per_epoch=2, weight_decay=weight_decay)
    rng = np.random.default_rng(3)
    model = TShot()
    tree = jax.tree.map(lambda x: x.astype(np.float32) + 0.05, branch_to_tree(model))
    load_branch(model, tree)
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree) for _ in range(4)]

    def set_grads(module, g):
        shadow = load_branch(TShot(), g)
        for p, s in zip(module.parameters(), shadow.parameters()):
            p.grad = s.detach().clone()

    tx = jloop.make_optimizer(JCfg(**cfg))
    jparams, jstate = tree, tx.init(tree)
    opt, sched = tloop.make_optimizer(TCfg(**cfg), model.parameters())
    for n, g in enumerate(grads):
        if n == 2:
            resumed = TShot()
            state = tloop.create_train_state(resumed, TCfg(**cfg), device="cpu")
            load_train_state(state, jax.device_get(jparams), jax.device_get(jstate[0].mu),
                             jax.device_get(jstate[0].nu), int(jstate[0].count))
            assert state.step == 2 and state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-3)
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        set_grads(model, g)
        opt.step()
        sched.step()
        _assert_trees_close(branch_to_tree(model), jax.device_get(jparams), 0, atol=1e-6)
        if n == 2:
            set_grads(state.module, g)
            state.optimizer.step()
            _assert_trees_close(branch_to_tree(state.module), jax.device_get(jparams), 0, atol=1e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.5 ** 2)


@pytest.fixture(scope="module")
def shot_reference():
    """The JAX package's shot step, compiled once for this file."""
    cfg, params, step, grad_fn = _jax_setup("shot")
    return cfg, params, step, grad_fn, _batch("shot")


def test_shot_step_loss_gradients_and_curve_match_jax(shot_reference, tmp_path):
    """One rank: the first step's loss rtol 1e-5 and gradients within 1e-4 of
    each leaf's largest entry; the loss curve of 5 steps rtol 1e-3."""
    cfg, params, step, grad_fn, batch = shot_reference
    keys, u = _uniforms(STEPS)
    jbatch = jax.tree.map(jnp.asarray, batch)
    loss0, jgrads = grad_fn(params, jbatch, keys[0])
    state = jloop.TrainState(jnp.zeros((), jnp.int32), params, jloop.make_optimizer(cfg).init(params))
    want = []
    for key in keys:
        state, m = step(state, jbatch, key)
        want.append([float(m[k]) for k in ("cls", "scale", "total")])
    metrics, grads = _run_port(1, "shot", tmp_path, params, batch, u, STEPS)
    np.testing.assert_allclose(metrics[0, 2], float(loss0), rtol=1e-5)
    _assert_trees_close(grads, jax.device_get(jgrads), 1e-4)
    np.testing.assert_allclose(metrics, np.array(want), rtol=1e-3)
    assert metrics[-1, 2] < metrics[0, 2]


def test_world2_step_equals_the_one_rank_step(shot_reference, tmp_path):
    """Two ranks, one frame each, against one rank on both frames: metrics
    and averaged gradients within 1e-6 (relative to each leaf's largest entry)."""
    _, params, _, _, batch = shot_reference
    _, u = _uniforms(1)
    (tmp_path / "w1").mkdir()
    (tmp_path / "w2").mkdir()
    m1, g1 = _run_port(1, "shot", tmp_path / "w1", params, batch, u, 1)
    m2, g2 = _run_port(2, "shot", tmp_path / "w2", params, batch, u, 1)
    np.testing.assert_allclose(m2, m1, rtol=1e-6)
    _assert_trees_close(g2, g1, 1e-6)


def test_dino_step_matches_jax(tmp_path):
    """The frozen-descriptor visual branch (64-wide descriptors): first loss
    rtol 1e-5, gradients 1e-4, three-step curve rtol 1e-3."""
    cfg, params, step, grad_fn = _jax_setup("dino")
    batch = _batch("dino")
    keys, u = _uniforms(3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    loss0, jgrads = grad_fn(params, jbatch, keys[0])
    state = jloop.TrainState(jnp.zeros((), jnp.int32), params, jloop.make_optimizer(cfg).init(params))
    want = []
    for key in keys:
        state, m = step(state, jbatch, key)
        want.append([float(m[k]) for k in ("cls", "scale", "total")])
    metrics, grads = _run_port(1, "dino", tmp_path, params, batch, u, 3)
    np.testing.assert_allclose(metrics[0, 2], float(loss0), rtol=1e-5)
    _assert_trees_close(grads, jax.device_get(jgrads), 1e-4)
    np.testing.assert_allclose(metrics, np.array(want), rtol=1e-3)


@pytest.mark.parametrize("dtype,loss_rtol,grad_rel", [("float32", 1e-5, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_visual_step_matches_jax(dtype, loss_rtol, grad_rel, tmp_path):
    """The end-to-end visual step through a 2-block ViT ("hbm" attention) on
    two ranks. float32: loss rtol 1e-5 and every gradient leaf, the
    backbone's included, within 1e-4 of the leaf's largest entry (measured:
    4e-6 at worst). bfloat16 rounds the logits before the max: loss rtol 2e-2
    and every leaf within 5e-2 (measured: 2.3e-2 at worst).

    The batch is seed 1 for a reason. The forward values of the two packages
    differ by about 3e-6, and a ReLU whose input lies that close to zero is
    on in one package and off in the other; one such unit moves the gradient
    of its layer's bias, and of every leaf before it, by up to 1e-2 of the
    leaf's largest entry (seeds 0, 2 and 5 have one, in the tuple encoder or
    the logit head; the port at two thread counts shows the same). On seeds 1
    and 3 no unit sits in that gap and all leaves agree to 4e-6."""
    cfg, params, step, grad_fn = _jax_setup("dino-e2e", dtype)
    batch = _batch("dino-e2e", seed=1)
    keys, u = _uniforms(1)
    loss0, jgrads = grad_fn(params, jax.tree.map(jnp.asarray, batch), keys[0])
    metrics, grads = _run_port(2, "dino-e2e", tmp_path, params, batch, u, 1, dtype)
    np.testing.assert_allclose(metrics[0, 2], float(loss0), rtol=loss_rtol)
    _assert_trees_close(grads, jax.device_get(jgrads), grad_rel)
    bb = dict(_leaves(grads["backbone"]))
    assert float(np.abs(bb["params/patch_embed/kernel"]).max()) > 0


def test_backbone_lr_scale_and_kernel_attention_guard():
    """A ViT on kernel K1 cannot train: `VisualModel` refuses it, and `mha`
    itself raises on an input that requires grad instead of returning a
    tensor cut from the graph. Under no_grad it runs."""
    with pytest.raises(ValueError, match="hbm"):
        tvisual.VisualModel(tdino.DinoViT(tdino.ViTConfig(**VIT)), TDino(desc_dim=128))
    q, k, v = (torch.randn(2, 9, 64).bfloat16() for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match='attn_impl="hbm"'):
        attention.mha(q, k, v)
    with torch.no_grad():
        assert attention.mha(q, k, v).shape == (2, 9, 64)
    assert attention.mha(q.detach(), k, v).shape == (2, 9, 64)
    vit = tdino.DinoViT(tdino.ViTConfig(**VIT, compute_dtype="float32"))
    with pytest.raises(RuntimeError, match="no backward"):
        vit(torch.rand(56, 56, 3))


def test_make_train_step_needs_a_process_group():
    with pytest.raises(ValueError, match="mesh"):
        tloop.make_train_step(TShot(), TCfg(), "shot", None)
    from cppf2_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        train_category("mug", "shot", TCfg(), records=None, device="cpu")


# ---------------------------------------------------------------------------
# files: msgpack, backbone, checkpoints
# ---------------------------------------------------------------------------

def test_msgpack_bytes_equal_flax_and_each_package_reads_the_other(tmp_path):
    model = TDino(desc_dim=64)
    tree = branch_to_tree(model)
    assert dumps_msgpack(tree) == flax.serialization.msgpack_serialize(tree)
    with open("ckpts_r3/shot/mug/params.msgpack", "rb") as f:
        raw = f.read()
    assert dumps_msgpack(loads_msgpack(raw)) == raw
    # the port writes, the JAX package reads into its own template
    path = tckpt.export_params_msgpack(str(tmp_path / "t" / "params.msgpack"), model)
    jm = JDino()
    template = jm.init(jax.random.key(0), jnp.zeros((16, 3)), jnp.zeros((16, 64)),
                       jnp.zeros((8, 5), jnp.int32))
    jparams = jckpt.load_params_msgpack(path, template)
    pts = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    desc = np.random.default_rng(1).normal(size=(16, 64)).astype(np.float32)
    ti = np.random.default_rng(2).integers(0, 16, (8, 5))
    want = jm.apply(jparams, jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(ti))
    with torch.no_grad():
        got = model(torch.from_numpy(pts), torch.from_numpy(desc), torch.from_numpy(ti))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-5)
    # the JAX package writes, the port reads
    jpath = jckpt.export_params_msgpack(str(tmp_path / "j" / "params.msgpack"), template)
    _assert_trees_close(tckpt.load_params_msgpack(jpath), jax.device_get(template), 0)
    with pytest.raises(TypeError):
        dumps_msgpack({"a": [1, 2]})


def test_backbone_files_cross_packages(tmp_path):
    """save_backbone / load_backbone: the two files of one package load in
    the other and give the same tokens (float32, atol 2e-3: the reference
    rounds its attention weights to the compute dtype, here float32)."""
    cfg = dict(VIT, compute_dtype="float32")
    jvit = jdino.DinoViT(jdino.ViTConfig(**cfg))
    jparams = jvit.init(jax.random.key(2), jnp.zeros((56, 56, 3)))
    jdino.save_backbone(str(tmp_path / "j" / "backbone"), jparams, jvit.cfg, stride=8, out_size=32)
    tvit, tcfg, stride, out_size = tdino.load_backbone(str(tmp_path / "j" / "backbone"), device="cpu",
                                                       compute_dtype="float32", attn_impl="hbm")
    assert (stride, out_size, tcfg.embed_dim, tcfg.attn_impl) == (8, 32, 128, "hbm")
    img = np.random.default_rng(0).uniform(size=(56, 56, 3)).astype(np.float32)
    want = np.asarray(jvit.apply(jparams, jnp.asarray(img)))
    with torch.no_grad():
        np.testing.assert_allclose(tvit(torch.from_numpy(img)).numpy(), want, atol=2e-3)
    tdino.save_backbone(str(tmp_path / "t" / "backbone"), tvit, stride=8, out_size=32)
    with open(tmp_path / "t" / "backbone.json") as f, open(tmp_path / "j" / "backbone.json") as g:
        assert json.load(f) == json.load(g)
    back, jcfg, jstride, jout = jdino.load_backbone(str(tmp_path / "t" / "backbone"),
                                                    compute_dtype="float32")
    assert (jstride, jout, jcfg.depth) == (8, 32, 2)
    np.testing.assert_allclose(np.asarray(jvit.apply(back, jnp.asarray(img))), want, atol=1e-6)
    _assert_trees_close(vit_to_tree(load_vit(tdino.DinoViT(tcfg), jax.device_get(jparams))),
                        jax.device_get(jparams), 0)
    assert tdino.load_backbone(str(tmp_path / "none")) is None


def test_checkpoint_layout_restore_and_params(tmp_path):
    """step_%08d + `last`, as the JAX package lays a run out; a restored
    state continues bit for bit; restore_params gives a loadable tree."""
    cfg = TCfg(**CFG)
    gen = torch.Generator().manual_seed(0)
    state = tloop.create_train_state(TShot(), cfg, gen, device="cpu")
    for p in state.module.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()
    state.scheduler.step()
    state.step = 1
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    path = tckpt.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000001"
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    with open(tmp_path / "last") as f:
        assert f.read() == "step_00000001"
    fresh = tckpt.restore_checkpoint(path, tloop.create_train_state(TShot(), cfg, device="cpu"))
    assert fresh.step == 1 and fresh.scheduler.last_epoch == 1
    for s in (state, fresh):
        for p in s.module.parameters():
            p.grad = torch.ones_like(p)
        s.optimizer.step()
    for a, b in zip(state.module.parameters(), fresh.module.parameters()):
        assert torch.equal(a, b)
    tree = tckpt.restore_params(path)
    loaded = load_branch(TShot(), tree)
    assert not torch.equal(next(loaded.parameters()), next(state.module.parameters()))
    tckpt.restore_checkpoint(path, state)
    for a, b in zip(loaded.parameters(), state.module.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

_DRIVER_BODY = """
import json, os
from cppf2_torch.config import TrainConfig
from cppf2_torch.eval.driver import load_category_models
from cppf2_torch.models.dinov2 import DinoFeatureExtractor, ViTConfig
from cppf2_torch.train.checkpoints import latest_checkpoint
from cppf2_torch.train.driver import train_category
kw = dict({source}, log_every=1, ckpt_every_epochs=1, frames_in_pool=4,
          progress=lambda s: None, device="cpu", e2e_out_size=32,
          vit_cfg={vit_cfg})
cfg = TrainConfig(max_epochs=1, **{cfg!r})
out = TMP + "/run"
s1 = train_category("mug", {branch!r}, cfg, out, **kw)
assert s1.step == 3 and latest_checkpoint(out).endswith("step_00000003")
# resume: one more epoch continues from the checkpoint, not from step 0
s2 = train_category("mug", {branch!r}, TrainConfig(max_epochs=2, **{cfg!r}), out, **kw)
assert s2.step == 6 and latest_checkpoint(out).endswith("step_00000006")
dist.barrier()   # every rank has read the run directory before rank 0 moves it
if RANK == 0:
    rows = [json.loads(l) for l in open(out + "/metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6], rows
    assert all(np.isfinite(r["total"]) for r in rows)
    if {branch!r} == "dino-e2e":
        assert os.path.exists(out + "/params.msgpack") and os.path.exists(out + "/backbone.json")
    else:
        # the evaluation loader takes the newest checkpoint of a run directory
        os.makedirs(TMP + "/ck/" + {sub!r}, exist_ok=True)
        os.rename(out, TMP + "/ck/" + {sub!r} + "/mug")
        m = load_category_models(TMP + "/ck", ["mug"], torch.float32, "cpu")["mug"]
        got = getattr(m, {sub!r}).tuple_encoder.res0.fc1.weight
        assert torch.equal(got, s2.module.tuple_encoder.res0.fc1.weight)
"""


@pytest.mark.parametrize("branch,world", [("shot", 2), ("dino", 1), ("dino-e2e", 1)])
def test_train_category_from_jax_written_records(branch, world, tmp_path):
    """train_category on a container the JAX package's RecordWriter wrote: 3
    steps, a checkpoint, a resumed second epoch, metrics.jsonl; the e2e branch
    exports the head and the backbone, which the JAX package then loads."""
    rng = np.random.default_rng(5)
    frames = [{k: v[0] for k, v in _batch(branch, seed=s).items()} for s in range(6)]
    schema = {k: (v.shape, v.dtype) for k, v in frames[0].items()}
    with JRecordWriter(str(tmp_path / "train.rec"), schema) as w:
        for f in frames:
            w.append(f)
    vit_cfg = ("__import__('cppf2_torch.models.dinov2').models.dinov2.ViTConfig(**%r)" % VIT
               if branch == "dino-e2e" else "None")
    run_ranks(world, _DRIVER_BODY.format(branch=branch, cfg=CFG, vit_cfg=vit_cfg, source=_RECORDS,
                                         sub="shot" if branch == "shot" else "dino"), tmp_path)
    if branch == "dino-e2e":
        _assert_exports_load_in_jax(tmp_path, rng)


_RECORDS = 'records=TMP + "/train.rec"'
# the pool comes from the synthetic generator: 64 x 80 renders; the frozen
# descriptors from a depth-1 ViT at stride 4 on 32 x 32 crops
_RENDERED = ('render_hw=(64, 80), n_points=128, dino_extractor=DinoFeatureExtractor('
             'cfg=ViTConfig(embed_dim=64, depth=1, num_heads=4, pretrain_grid=4), out_size=32, '
             'device="cpu").init_random(torch.Generator().manual_seed(0))')


@pytest.mark.parametrize("branch,world", [("shot", 1), ("shot", 2), ("dino", 1), ("dino-e2e", 1)])
def test_train_category_renders_its_pool(branch, world, tmp_path):
    """train_category without records: the pool and every refresh rendered
    by the synthetic generator (64 x 80 renders, 128 points), 3
    steps, a checkpoint, a resumed second epoch, metrics.jsonl; "dino" takes
    64-wide descriptors from its extractor; the e2e branch exports the head
    and the backbone, which the JAX package then loads."""
    vit_cfg = ("__import__('cppf2_torch.models.dinov2').models.dinov2.ViTConfig(**%r)" % VIT
               if branch == "dino-e2e" else "None")
    run_ranks(world, _DRIVER_BODY.format(branch=branch, cfg=CFG, vit_cfg=vit_cfg, source=_RENDERED,
                                         sub="shot" if branch == "shot" else "dino"), tmp_path)
    if branch == "dino-e2e":
        _assert_exports_load_in_jax(tmp_path, np.random.default_rng(5))


def _assert_exports_load_in_jax(tmp_path, rng):
    params, cfg, stride, out_size = jdino.load_backbone(str(tmp_path / "run" / "backbone"))
    assert (cfg.embed_dim, cfg.pretrain_grid, stride, out_size) == (128, 4, 8, 32)
    grid = jdino.DinoViT(cfg).apply(params, jnp.asarray(rng.uniform(size=(56, 56, 3)), jnp.float32))
    assert grid.shape == (4, 4, 128) and bool(jnp.isfinite(grid).all())
    head = load_params_msgpack(str(tmp_path / "run" / "params.msgpack"))
    assert head["params"]["desc_transform"]["kernel"].shape == (128, 256)


@pytest.mark.parametrize("interp_impl", ["gather", "onehot"])
def test_frame_crop_and_descriptors_match_jax(interp_impl):
    """The host crop of a rendered frame (the JAX generator's, 64 x 80) at 32
    x 32 and the cloud's pixels in it: crop within 1e-5 of the reference's
    cv2 crop (measured: equal), keypoints within 1e-4 px; then the
    descriptors of a stride-4 extractor (depth-1 ViT in float32, weights
    carried) within the f32 band of dinov2's tests, 2e-3."""
    gen = jsynth.SyntheticFrameGenerator(JCATS["mug"], n_max=128, height=64, width=80, shot_k=16,
                                         surface_samples=4000, seed=3)
    frame = gen.next_frame()
    port = SynthFrame(*(torch.from_numpy(np.array(x)) for x in frame))
    want_crop, want_kp = jdriver._frame_crop_kp(frame, 32)
    got_crop, got_kp = tdriver._frame_crop_kp(port, 32)
    assert got_crop.shape == (32, 32, 3) and got_kp.shape == (128, 2)
    np.testing.assert_allclose(got_crop, want_crop, atol=1e-5)
    np.testing.assert_allclose(got_kp, want_kp, atol=1e-4)
    kw = dict(embed_dim=64, depth=1, num_heads=4, pretrain_grid=4, compute_dtype="float32")
    jext = jdino.DinoFeatureExtractor(cfg=jdino.ViTConfig(**kw), interp_impl=interp_impl, out_size=32)
    jext.init_random(hw=(32, 32), seed=1)
    text = tdino.DinoFeatureExtractor(params=jax.device_get(jext.params), cfg=tdino.ViTConfig(**kw),
                                      interp_impl=interp_impl, out_size=32, device="cpu")
    want = np.asarray(jdriver._frame_descriptors(frame, jext))
    got = tdriver._frame_descriptors(port, text).numpy()
    assert got.shape == want.shape == (128, 64)
    np.testing.assert_allclose(got, want, atol=2e-3)
