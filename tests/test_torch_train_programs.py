"""The JAX package's last jitted programs in the port, on the CPU: the
synthetic frame (`cppf2_tpu/data/synthetic.py::_device_frame` and
`_device_frame_raster`) and the train steps of the `shot`, `dino` and
`dino-e2e` branches (`cppf2_tpu/train/loop.py`, `train/visual.py`).

On the card each is a captured CUDA graph (`cppf2_torch/eval/programs.py`);
here it runs eagerly. Held here: no program body reads the device back or
builds a tensor from host values (either breaks a capture), the programs'
keys (static arguments and input shapes and, for a step, the addresses of
the weights, gradients and optimizer state it writes), the capturable AdamW
across an lr boundary against optax, and the stateful form of a program. The
frames and the steps themselves stay held against the JAX package by
`test_torch_data.py` and `test_torch_train.py`.

Ranks are gloo subprocesses (test_torch_parallel.run_ranks) that never import
JAX. AdamW refuses `capturable=True` for CPU parameters; the ranks widen its
device check to the CPU, so that their steps run the update the card captures.
"""

import inspect
import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.config import CATEGORIES as TCATS
from cppf2_torch.data import synthetic as tsynth
from cppf2_torch.eval import programs
from cppf2_tpu.config import TrainConfig as JCfg
from cppf2_tpu.models import ShotBranch as JShot
from cppf2_tpu.train import loop as jloop
from test_torch_parallel import run_ranks
from test_torch_programs import _HostReads
from test_torch_train import OUT, STRIDE, TUPLES, VIT, _batch, _uniforms

SMALL_FRAME = dict(n_max=128, shot_k=16, surface_samples=3000, height=48, width=64)
# the lr halves after every second update
BOUNDARY = dict(tuples_per_step=TUPLES, n_points=128, lr_step_epochs=1, steps_per_epoch=2)

# what a rank runs first: AdamW's device check widened to the CPU, so that
# `make_optimizer(..., capturable=True)` builds the optimizer the card uses
_CAPTURABLE_ON_CPU = """
import json
import torch.optim.adam as adam
adam._get_capturable_supported_devices = lambda supports_xla=True: ["cuda", "cpu"]
"""


def _watch(monkeypatch):
    """Every program call from now on, with what its body read back: a list
    of (program key, operators seen)."""
    calls = []
    real = programs.Program.__call__

    def watched(self, *args):
        mode = _HostReads()
        with mode:
            out = real(self, *args)
        calls.append((self.key, mode.seen))
        return out

    monkeypatch.setattr(programs.Program, "__call__", watched)
    return calls


def test_stateful_program_runs_its_body_once_a_call():
    """A body that adds one to a buffer, called three times, adds three."""
    buf = torch.zeros(3)

    def body(x):
        buf.add_(x)
        return buf.clone()

    cache = {}
    for _ in range(3):
        out = programs.program(cache, ("toy",), body, (torch.ones(3),), stateful=True)(torch.ones(3))
    (prog,) = cache.values()
    assert prog.stateful and prog.eager_runs == 3
    assert torch.equal(buf, torch.full((3,), 3.0)) and torch.equal(out, buf)


@pytest.mark.parametrize("renderer,lighting", [("splat", False), ("splat", True), ("raster", True)])
def test_frame_programs_read_nothing_back_and_are_keyed_as_jax_jits(renderer, lighting, monkeypatch):
    """Four frames of one generator (default lighting, or drawn lighting and
    texture), each attempt through one frame program, none of whose bodies
    reads the device back or builds a tensor from host values once its
    constants exist. The splat frames, of other meshes and scales, share one
    program; the raster frames have one per padded mesh bucket, as the JAX
    package compiles `_device_frame_raster` once per bucket."""
    gen = tsynth.SyntheticFrameGenerator(TCATS["mug"], seed=3, renderer=renderer,
                                         randomize_lighting=lighting, texture=lighting,
                                         z_range=(0.5, 0.8), device="cpu", **SMALL_FRAME)
    buckets, pad = set(), tsynth._pad_mesh

    def padded(*args, **kw):
        out = pad(*args, **kw)
        buckets.add(tuple(x.shape for x in out))
        return out

    monkeypatch.setattr(tsynth, "_pad_mesh", padded)
    monkeypatch.setattr(tsynth, "_FRAME_PROGRAMS", {})
    gen.next_frame()
    calls = _watch(monkeypatch)
    scales = {float(gen.next_frame().scale_norm) for _ in range(3)}
    assert calls and all(not seen for _, seen in calls), calls
    assert {key[0][:2] for key, _ in calls} == {("synthetic frame", renderer)}
    assert len(scales) == 3
    progs = tsynth._FRAME_PROGRAMS
    if renderer == "splat":
        assert len(progs) == 1
    else:
        # the signature's first two leaves: the padded vertices and faces
        assert len(progs) == len(buckets)
        assert {(key[1][1][0][0], key[1][1][1][0]) for key in progs} == buckets


_STEPS_RANK = _CAPTURABLE_ON_CPU + """
from torch.utils._python_dispatch import TorchDispatchMode
{host_reads}
from cppf2_torch import train
from cppf2_torch.config import TrainConfig
from cppf2_torch.eval import programs
from cppf2_torch.models import dinov2
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.parallel import make_mesh
from cppf2_torch.train import checkpoints, loop
torch.manual_seed(0)
cfg = TrainConfig(**{cfg!r})
mesh = make_mesh(device="cpu")
call = programs.Program.__call__
out = {{}}
for branch in ("shot", "dino", "dino-e2e"):
    x = np.load(TMP + "/" + branch + ".npz")
    batch = {{k: x[k] for k in x.files}}
    gen = torch.Generator().manual_seed(1)
    if branch == "dino-e2e":
        vit = dinov2.DinoViT(dinov2.ViTConfig(**{vit!r}, compute_dtype="float32", attn_impl="hbm"))
        head = DinoBranch(desc_dim=128)
        model = train.VisualModel(vit, head)
        step = train.make_visual_train_step(vit, head, cfg, {out}, {stride}, mesh=mesh)
    else:
        model = ShotBranch() if branch == "shot" else DinoBranch(desc_dim=64)
        step = train.make_train_step(model, cfg, branch, mesh)
    state = loop.TrainState(0, model, *loop.make_optimizer(cfg, model.parameters(), capturable=True))
    # the multi-tensor update's CPU branch adds a host-built torch.tensor(1.0) to
    # CPU step counts (its CUDA branch adds 1 to device ones); the single-tensor
    # update has no CPU branch and stands for the card's here
    state.optimizer.param_groups[0]["foreach"] = False
    for _ in range(2):
        step(state, batch, generator=gen)
    seen = []

    def watched(self, *args):
        mode = _HostReads()
        with mode:
            res = call(self, *args)
        seen.append([self.key[0][0], mode.seen])
        return res

    programs.Program.__call__ = watched
    step(state, batch, generator=gen)
    programs.Program.__call__ = call
    counts = [len(step.programs)]
    checkpoints.restore_checkpoint(checkpoints.save_checkpoint(TMP + "/ck_" + branch, state), state)
    step(state, batch, generator=gen)
    counts.append(len(step.programs))
    step(state, {{k: v[:1] for k, v in batch.items()}}, generator=gen)
    counts.append(len(step.programs))
    adam = state.optimizer.state[next(model.parameters())]["step"]
    out[branch] = dict(seen=seen, counts=counts, steps=[state.step, float(adam)])
json.dump(out, open(TMP + "/out.json", "w"))
"""


def test_step_programs_read_nothing_back_and_are_keyed_on_the_state(tmp_path):
    """The three branches' train steps on one gloo rank, with the capturable
    AdamW: the third step's body reads nothing back and builds no tensor
    from host values; the three steps of one state are one program; the
    state restored from its checkpoint (new optimizer state tensors and lr)
    gets another; a batch of one frame another again. Five steps in all,
    five AdamW updates."""
    for branch in ("shot", "dino", "dino-e2e"):
        np.savez(tmp_path / f"{branch}.npz", **_batch(branch))
    run_ranks(1, _STEPS_RANK.format(host_reads=inspect.getsource(_HostReads), cfg=BOUNDARY, vit=VIT,
                                    out=OUT, stride=STRIDE), tmp_path)
    with open(tmp_path / "out.json") as f:
        out = json.load(f)
    for branch, name in (("shot", "step"), ("dino", "step"), ("dino-e2e", "visual step")):
        assert out[branch]["seen"] == [[name, []]], (branch, out[branch]["seen"])
        assert out[branch]["counts"] == [1, 2, 3], branch
        assert out[branch]["steps"] == [5, 5.0], branch


_BOUNDARY_RANK = _CAPTURABLE_ON_CPU + """
from cppf2_torch.config import TrainConfig
from cppf2_torch.models.checkpoints import load_params_msgpack
from cppf2_torch.models.cppf import ShotBranch
from cppf2_torch.models.porting import load_tree
from cppf2_torch.parallel import make_mesh
from cppf2_torch.train import loop
x = np.load(TMP + "/in.npz")
cfg = TrainConfig(**{cfg!r})
model = load_tree(ShotBranch(), load_params_msgpack(TMP + "/params.msgpack"))
state = loop.TrainState(0, model, *loop.make_optimizer(cfg, model.parameters(), capturable=True))
lr = state.optimizer.param_groups[0]["lr"]
step = loop.make_train_step(model, cfg, "shot", make_mesh(device="cpu"))
batch = {{k: x[k] for k in x.files if k != "u"}}
metrics, lrs = [], []
for s in range({steps}):
    state, m = step(state, batch, tuple_u=torch.from_numpy(x["u"][s]))
    metrics.append([float(m[k]) for k in ("cls", "scale", "total")])
    assert state.optimizer.param_groups[0]["lr"] is lr
    lrs.append(float(lr))
adam = float(state.optimizer.state[next(model.parameters())]["step"])
json.dump(dict(metrics=metrics, lrs=lrs, lr_dtype=str(lr.dtype), adam=adam, n=len(step.programs)),
          open(TMP + "/out.json", "w"))
"""


def test_capturable_adamw_follows_optax_across_the_lr_boundary(tmp_path):
    """Five shot steps with the lr halved after every second update: the
    capturable AdamW with its float32 lr tensor, rewritten in place by the
    scheduler, follows the JAX package's jitted step (optax's AdamW and
    schedule): the first loss rtol 1e-5 and the curve rtol 1e-3, as
    `test_torch_train.py::test_shot_step_loss_gradients_and_curve_match_jax`
    holds the plain AdamW; each update's lr that of `make_lr_schedule` in
    float32; one program for the five steps."""
    steps = 5
    cfg = JCfg(**BOUNDARY)
    model = JShot()
    params = jax.device_get(model.init(jax.random.key(0), jnp.zeros((16, 3)), jnp.zeros((16, 352)),
                                       jnp.zeros((16, 3)), jnp.zeros((8, 5), jnp.int32)))
    batch = _batch("shot")
    keys, u = _uniforms(steps)
    jstep = jloop.make_train_step(model, cfg, "shot")
    state = jloop.TrainState(jnp.zeros((), jnp.int32), params, jloop.make_optimizer(cfg).init(params))
    want = []
    for key in keys:
        state, m = jstep(state, jax.tree.map(jnp.asarray, batch), key)
        want.append([float(m[k]) for k in ("cls", "scale", "total")])
    with open(tmp_path / "params.msgpack", "wb") as f:
        f.write(flax.serialization.msgpack_serialize(params))
    np.savez(tmp_path / "in.npz", u=u, **batch)
    run_ranks(1, _BOUNDARY_RANK.format(cfg=BOUNDARY, steps=steps), tmp_path)
    with open(tmp_path / "out.json") as f:
        out = json.load(f)
    metrics = np.array(out["metrics"])
    np.testing.assert_allclose(metrics[0, 2], want[0][2], rtol=1e-5)
    np.testing.assert_allclose(metrics, np.array(want), rtol=1e-3)
    schedule = jloop.make_lr_schedule(cfg)
    assert out["lrs"] == [float(np.float32(schedule(jnp.asarray(s + 1)))) for s in range(steps)]
    assert out["lr_dtype"] == "torch.float32" and out["adam"] == steps and out["n"] == 1
