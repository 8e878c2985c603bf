"""The port's copy of the JAX package's seeded streams against JAX on the
CPU: the threefry PRNG (`key`, `fold_in`, `split`, `bits`, `uniform`,
`permutation` to the bit; `normal` and `truncated_normal` within a few
ulps), the init trees a seed gives (the ViT, the branch MLPs, the visual
trainer's pair), the trainer's default backbone, and a synthetic frame's
draws and gray image.

Measured bounds (JAX 0.9.0, flax 0.12.3, on the CPU): `erf_inv` rounds 99% of
inputs as XLA does and the rest within 2 ulps (XLA's own `log1p` rounds
otherwise); `normal` and `truncated_normal` within 3 ulps, 99% equal; a
Dense kernel (truncated normal times its float32 standard deviation)
within 4 ulps, over 98.5% of a tree's values equal (98.9% per leaf
measured on the large ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.config import CATEGORIES as TCATS
from cppf2_torch.config import TrainConfig as TCfg
from cppf2_torch.data import synthetic as tsynth
from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models import jax_random as jr
from cppf2_torch.models.cppf import DinoBranch as TDino
from cppf2_torch.models.cppf import ShotBranch as TShot
from cppf2_torch.models.porting import branch_to_tree, vit_to_tree
from cppf2_torch.train import driver as tdriver
from cppf2_torch.train import loop as tloop
from cppf2_torch.train import visual as tvisual
from cppf2_tpu.config import CATEGORIES as JCATS
from cppf2_tpu.config import TrainConfig as JCfg
from cppf2_tpu.data import synthetic as jsynth
from cppf2_tpu.models import DinoBranch as JDino
from cppf2_tpu.models import dinov2 as jdino
from cppf2_tpu.train import visual as jvisual
from test_torch_data import SMALL, jax_frame_draws

SEEDS = (0, 123456, 2**31 - 1)
# ulps between float32 results of the two packages (measured, module docstring)
NORMAL_ULPS, KERNEL_ULPS = 3, 4


def _words(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_threefry_is_the_partitionable_one():
    """The port reproduces JAX's partitionable threefry layout, which this
    JAX has on by default; flax hashes no separators."""
    import flax

    assert jax.config.jax_threefry_partitionable
    assert not flax.config.flax_fix_rng_separator


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_and_bits_bit_for_bit(seed):
    k = jax.random.key(seed)
    assert _words(k) == jr.key(seed)
    for data in (0, 1, 5, 2**32 - 1):
        assert _words(jax.random.fold_in(k, data)) == jr.fold_in(jr.key(seed), data)
    for n in (2, 3, 24):
        assert [_words(x) for x in jax.random.split(k, n)] == jr.split(jr.key(seed), n)
    for shape in ((), (7,), (3, 5), (2, 3, 4)):
        want = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
        np.testing.assert_array_equal(jr.bits(jr.key(seed), shape).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_permutation_bit_for_bit(seed):
    k = jax.random.key(seed)
    for lo, hi in ((0.0, 1.0), (0.05, 0.3), (0.0, 2 * np.pi), (1.5, 3.0), (-0.9544997, 0.9544997)):
        for shape in ((), (3, 50)):
            want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
            np.testing.assert_array_equal(jr.uniform(jr.key(seed), shape, lo, hi).numpy(), want)
    for n in (1, 1000, 70000):   # one round below 2^(32/3) elements, two above
        want = np.asarray(jax.random.permutation(k, n))
        np.testing.assert_array_equal(jr.permutation(jr.key(seed), n).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal_within_ulps(seed):
    k = jax.random.key(seed)
    shape = (200, 500)
    for want, got in ((jax.random.normal(k, shape), jr.normal(jr.key(seed), shape)),
                      (jax.random.truncated_normal(k, -2, 2, shape),
                       jr.truncated_normal(jr.key(seed), -2, 2, shape))):
        ulps = _ulps(got.numpy(), want)
        assert ulps.max() <= NORMAL_ULPS, ulps.max()
        assert (ulps == 0).mean() > 0.985, (ulps == 0).mean()


def test_erf_inv_against_xla():
    x = np.random.default_rng(0).uniform(-1, 1, 400000).astype(np.float32)
    x[:4] = (-1.0, 1.0, 0.0, np.nextafter(np.float32(1), np.float32(0)))
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = jr.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:2], want[:2])   # -inf, +inf
    ulps = _ulps(got[2:], want[2:])
    assert ulps.max() <= 2 and (ulps == 0).mean() > 0.985, (ulps.max(), (ulps == 0).mean())


def test_fold_static_is_flax_hash():
    from flax.core.scope import _fold_in_static

    k = jax.random.key(3)
    for data in (("patch_embed", 1), (2,), ("blocks", "attn", "qkv", 3), ("a", 0), ("res10", 300)):
        assert _words(_fold_in_static(k, data)) == jr.fold_static(jr.key(3), data)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k], np.float32)


def assert_trees_within_ulps(got, want, ulps=KERNEL_ULPS, equal_share=0.985):
    """Same leaf names and shapes; every value within `ulps`, and at least
    `equal_share` of all values equal to the bit."""
    got = {n: (v.numpy() if isinstance(v, torch.Tensor) else v) for n, v in _leaves(got)}
    want = dict(_leaves(want))
    assert sorted(got) == sorted(want)
    equal = total = 0
    for name, w in want.items():
        g = np.asarray(got[name], np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        u = _ulps(g, w)
        assert u.max() <= ulps, (name, u.max())
        equal, total = equal + int((u == 0).sum()), total + u.size
    assert equal / total >= equal_share, equal / total


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


VIT_CASES = [dict(embed_dim=64, depth=3, num_heads=2, pretrain_grid=4),
             # ViT-L's widths at depth 1: flax folds names, so block 0's keys
             # are the full model's
             dict(embed_dim=1024, depth=1, num_heads=16, pretrain_grid=37),
             dict(embed_dim=64, depth=2, num_heads=2, pretrain_grid=4, quant="int8")]


@pytest.mark.parametrize("cfg", VIT_CASES, ids=["small", "vitl-depth1", "int8"])
def test_vit_init_tree_matches_flax(cfg):
    want = jdino.DinoViT(jdino.ViTConfig(**cfg)).init(jax.random.key(3), jnp.zeros((28, 28, 3)))
    got = tdino.init_tree(tdino.ViTConfig(**cfg), 3)
    assert_trees_within_ulps(_torch_tree(got), jax.device_get(want))


@pytest.fixture(scope="module")
def jax_fallback():
    """The JAX loader's random fallback for a category without checkpoints:
    `ShotBranch().init(jax.random.key(0), ...)` and `DinoBranch().init(
    key(1), ...)`, the trees `create_train_state` makes from those keys
    (its `model.init(key, *example)`; no parameter depends on the example's
    number of points). Made once: flax's eager init is slow."""
    from cppf2_tpu.eval import driver as jdrv

    return jdrv.load_category_models(None, ["can"], infer_dtype="float32")["can"]


@pytest.mark.parametrize("branch,seed", [("shot", 0), ("dino", 1)])
def test_branch_init_matches_create_train_state(branch, seed, jax_fallback):
    """`create_train_state(..., seed=s)`: the JAX package's
    `create_train_state(model, example, cfg, jax.random.key(s))` params."""
    tmodel = TShot() if branch == "shot" else TDino()
    state = tloop.create_train_state(tmodel, TCfg(), device="cpu", seed=seed)
    want = jax_fallback.shot_params if branch == "shot" else jax_fallback.dino_params
    assert_trees_within_ulps(branch_to_tree(state.module), jax.device_get(want))


def test_visual_train_state_matches_jax():
    """The dino-e2e pair: the key split in two, the backbone's tree from the
    first half, the head's from the second."""
    vit = dict(embed_dim=64, depth=2, num_heads=2, pretrain_grid=4)
    want = jvisual.create_visual_train_state(jdino.DinoViT(jdino.ViTConfig(**vit)), JDino(),
                                             JCfg(), jax.random.key(2), 32, 8).params
    state = tvisual.create_visual_train_state(tdino.DinoViT(tdino.ViTConfig(**vit, attn_impl="hbm")),
                                              TDino(desc_dim=64), TCfg(), device="cpu", seed=2)
    want = jax.device_get(want)
    assert_trees_within_ulps(vit_to_tree(state.module.backbone), want["backbone"])
    assert_trees_within_ulps(branch_to_tree(state.module.branch), want["branch"])


def test_train_category_default_backbone_is_the_jax_drivers(monkeypatch):
    """The fixed backbone `train_category(branch="dino")` builds without
    `dino_extractor` is the JAX driver's `init_random(hw=(256, 256),
    seed=cfg.seed)`, cast alike (bf16 matrices), here on a small ViT (the
    default config swapped). Before the seeded trees it drew other weights
    from a torch.Generator."""
    small = dict(embed_dim=64, depth=2, num_heads=2, pretrain_grid=4)
    built = []

    class Small(tdino.DinoFeatureExtractor):
        def __init__(self, **kw):
            super().__init__(cfg=tdino.ViTConfig(**small), out_size=32, **kw)
            built.append(self)

    monkeypatch.setattr(tdriver, "DinoFeatureExtractor", Small)

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    # stop once the pool is filled: only the backbone is wanted
    monkeypatch.setattr(tdriver, "_frame_descriptors", stop)
    monkeypatch.setattr(tdriver, "make_mesh", lambda device: None)
    monkeypatch.setattr(tdriver, "axis_size", lambda mesh, axis: 1)
    monkeypatch.setattr(tdriver.dist, "get_rank", lambda: 0)
    with pytest.raises(Stop):
        tdriver.train_category("mug", "dino", TCfg(seed=4), n_points=128, frames_in_pool=1,
                               render_hw=(120, 160), device="cpu", progress=lambda *_: None)
    jext = jdino.DinoFeatureExtractor(cfg=jdino.ViTConfig(**small))
    want = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax.device_get(jext.init_random(hw=(256, 256), seed=4)))
    assert_trees_within_ulps(vit_to_tree(built[0].model), want, ulps=1 << 16, equal_share=0.98)


def test_frame_draws_are_the_reference_ones():
    """`threefry_draws` (the generator's default) against the JAX-made
    `jax_frame_draws`: the permutation, the priorities and every uniform to
    the bit, the normals within 3 ulps."""
    n = 60 * 80
    for frame_seed, light_seed, texture in ((5, 9, True), (2**31 - 2, None, True), (7, 3, False)):
        got = tsynth.threefry_draws(frame_seed, light_seed, n, texture, "cpu")
        want = jax_frame_draws(frame_seed, light_seed, n, texture, "cpu")
        np.testing.assert_array_equal(got.perm.numpy(), want.perm.numpy())
        np.testing.assert_array_equal(got.prio.numpy(), want.prio.numpy())
        assert (got.lighting is None) == (want.lighting is None)
        assert (got.albedo is None) == (want.albedo is None)
        pairs = []
        if want.lighting is not None:
            pairs += list(zip(got.lighting, want.lighting))
        if want.albedo is not None:
            pairs += list(zip(got.albedo, want.albedo))
        for i, (g, w) in enumerate(pairs):
            if i in (0, 3):   # the direction normals
                assert _ulps(g.numpy(), w.numpy()).max() <= NORMAL_ULPS
            else:
                np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert tsynth.SyntheticFrameGenerator.draw_fn is tsynth.threefry_draws


def test_rendered_gray_image_is_the_jax_frames():
    """A textured, lit frame of the port's generator with its default draws
    against the JAX generator's `_device_frame` of the same seeds: equal
    meshes and poses from the numpy stream, the gray image and the depth
    within the renders' 1e-5."""
    cat = "mug"
    jgen = jsynth.SyntheticFrameGenerator(JCATS[cat], height=60, width=80, seed=3, **SMALL)
    tgen = tsynth.SyntheticFrameGenerator(TCATS[cat], height=60, width=80, seed=3, device="cpu",
                                          **SMALL)
    for _ in range(2):
        want, got = jgen.next_frame(), tgen.next_frame()
        np.testing.assert_allclose(got.gray.numpy(), np.asarray(want.gray), atol=1e-5)
        np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=1e-5)
        np.testing.assert_array_equal(got.rotation.numpy(), np.asarray(want.rotation))
    assert tgen.rng.bit_generator.state == jgen.rng.bit_generator.state


def test_loader_fallback_is_the_jax_loaders(jax_fallback):
    """A category without checkpoints: `load_category_models` gives each
    branch the JAX loader's random fallback (shot from key(0), dino from
    key(1))."""
    from cppf2_torch.eval import driver as tdrv

    want = jax_fallback
    got = tdrv.load_category_models(None, ["can"], torch.float32, "cpu")["can"]
    assert_trees_within_ulps(branch_to_tree(got.shot), jax.device_get(want.shot_params))
    assert_trees_within_ulps(branch_to_tree(got.dino), jax.device_get(want.dino_params))
