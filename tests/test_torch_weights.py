"""The port's weight routes against the JAX package's, on state dicts made
here from seeds (the reference's weights are not in the repo):

  * the BeyondCPPF Lightning checkpoint: `port_beyondcppf_state_dict` /
    `load_beyondcppf_checkpoint` give the JAX package's tree leaf for leaf,
    and the branches reproduce the torch forward of the reference layout
    within `tests/test_porting.py`'s tolerance (atol 2e-4);
  * the release tree: `_reference_ckpt_path` (numeric version order, the
    flat layout), `_check_hydra_sidecar`, and `load_category_models`' third
    fallback;
  * the official DINOv2 `.pth`: `port_torch_state_dict` /
    `load_dinov2_params` give JAX's tree, and the ViT's tokens agree within
    the f32 ViT parity tolerance of `tests/test_torch_dinov2.py` (2e-3);
  * flax's `lecun_normal` init (`init_flax_`, `DinoViT.init_random`): the
    support and the moments of `nn.Dense(...).init`'s kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cppf2_torch.eval import driver as tdriver
from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models import porting as tport
from cppf2_torch.models.cppf import DinoBranch, ShotBranch
from cppf2_torch.models.layers import Dense
from cppf2_torch.train.loop import init_flax_
from cppf2_tpu.eval import driver as jdriver
from cppf2_tpu.models import dinov2 as jdino
from cppf2_tpu.models import porting as jport
from test_porting import _inputs, _TorchDino, _TorchShot


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.float32, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def _branch_out(module, tree, pts, shot, nrm, desc, idx):
    module = tport.load_branch(module, tree).eval()
    t = torch.from_numpy
    with torch.no_grad():
        if isinstance(module, ShotBranch):
            return module(t(pts), t(shot), t(nrm), t(idx))
        return module(t(pts), t(desc), t(idx))


@pytest.mark.parametrize("branch", ["shot", "dino"])
def test_beyondcppf_state_dict_ports_as_jax_does(branch, tmp_path):
    """The tree equals JAX's leaf for leaf; the port's branch reproduces the
    reference-layout torch forward (logits and scales atol 2e-4); the
    Lightning file loads the same; a missing file is None."""
    torch.manual_seed(7)
    ref = (_TorchShot if branch == "shot" else _TorchDino)().eval()
    tree = tport.port_beyondcppf_state_dict(ref.state_dict(), branch)
    _assert_same_tree(tree, jport.port_beyondcppf_state_dict(ref.state_dict(), branch))
    pts, shot, nrm, desc, idx = _inputs(np.random.default_rng(0))
    module = ShotBranch(tuple_size=5) if branch == "shot" else DinoBranch(tuple_size=5)
    got = _branch_out(module, tree, pts, shot, nrm, desc, idx)
    t = torch.from_numpy
    with torch.no_grad():
        want = ref(t(pts), t(shot), t(nrm), t(idx).long()) if branch == "shot" else \
            ref(t(pts), t(desc), t(idx).long())
    np.testing.assert_allclose(got.logits.numpy(), want[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(got.scales.numpy(), want[1].numpy(), atol=2e-4)
    path = tmp_path / "last.ckpt"
    torch.save({"state_dict": ref.state_dict(), "epoch": 100}, path)
    _assert_same_tree(tport.load_beyondcppf_checkpoint(str(path), branch), tree)
    assert tport.load_beyondcppf_checkpoint(str(tmp_path / "missing.ckpt"), branch) is None
    with pytest.raises(ValueError):
        tport.port_beyondcppf_state_dict(ref.state_dict(), "cshot")


def _write_release_tree(root, cat, branch, module, version=0, num_more=3):
    """The reference release's layout (eval.py:88-99), as
    `tests/test_porting.py` writes it."""
    d = root / branch / f"{cat}-num_more-{num_more}"
    ck = d / "lightning_logs" / f"version_{version}" / "checkpoints"
    ck.mkdir(parents=True)
    (d / ".hydra").mkdir(exist_ok=True)
    (d / ".hydra" / "config.yaml").write_text(f"category:\n  name: {cat}\nnum_more: {num_more}\nres: 0.002\n")
    torch.save({"state_dict": module.state_dict(), "epoch": 100, "global_step": 20200}, ck / "last.ckpt")
    return ck / "last.ckpt"


def test_reference_ckpt_path_order_and_flat_layout(tmp_path):
    """version_10 after version_9 (natural order), as JAX's; the flat
    `{root}/{branch}/{cat}/last.ckpt` when no release tree is there; None
    without either."""
    for v in (9, 10, 2):
        ck = tmp_path / "shot" / "can-num_more-3" / "lightning_logs" / f"version_{v}" / "checkpoints"
        ck.mkdir(parents=True)
        (ck / "last.ckpt").write_bytes(b"")
    got = tdriver._reference_ckpt_path(str(tmp_path), "shot", "can")
    assert "version_10" in got and got == jdriver._reference_ckpt_path(str(tmp_path), "shot", "can")
    (tmp_path / "dino" / "can").mkdir(parents=True)
    (tmp_path / "dino" / "can" / "last.ckpt").write_bytes(b"")
    assert tdriver._reference_ckpt_path(str(tmp_path), "dino", "can") == \
        jdriver._reference_ckpt_path(str(tmp_path), "dino", "can") == str(tmp_path / "dino" / "can" / "last.ckpt")
    assert tdriver._reference_ckpt_path(str(tmp_path), "dino", "mug") is None


def test_hydra_sidecar_mismatch_raises(tmp_path):
    """num_more 4 implies tuple size 6 against the category's 5: ValueError
    from the checker and from the loader, as in JAX; a matching sidecar and
    a missing one pass."""
    torch.manual_seed(4)
    ck = _write_release_tree(tmp_path, "can", "shot", _TorchShot().eval(), num_more=4)
    cat = tdriver.CATEGORIES["can"]
    with pytest.raises(ValueError, match="num_more"):
        tdriver._check_hydra_sidecar(str(ck), cat)
    with pytest.raises(ValueError, match="num_more"):
        tdriver.load_category_models(str(tmp_path), ["can"], torch.float32, "cpu")
    with pytest.raises(ValueError, match="num_more"):
        jdriver.load_category_models(str(tmp_path), ["can"], infer_dtype="float32")
    good = _write_release_tree(tmp_path / "ok", "can", "shot", _TorchShot().eval())
    tdriver._check_hydra_sidecar(str(good), cat)
    tdriver._check_hydra_sidecar(str(tmp_path / "bare" / "last.ckpt"), cat)


def test_load_category_models_third_fallback(tmp_path):
    """A release tree with two versions of each branch: the port loads
    version_10, the tree JAX's loader gives, and both branches reproduce the
    reference-layout torch forward (atol 2e-4)."""
    torch.manual_seed(3)
    old_shot, old_dino = _TorchShot().eval(), _TorchDino().eval()
    shot, dino = _TorchShot().eval(), _TorchDino().eval()
    for v, (s, d) in ((9, (old_shot, old_dino)), (10, (shot, dino))):
        _write_release_tree(tmp_path, "can", "shot", s, version=v)
        _write_release_tree(tmp_path, "can", "dino", d, version=v)
    got = tdriver.load_category_models(str(tmp_path), ["can"], torch.float32, "cpu")["can"]
    want = jdriver.load_category_models(str(tmp_path), ["can"], infer_dtype="float32")["can"]
    _assert_same_tree(tport.branch_to_tree(got.shot), jax.device_get(want.shot_params))
    _assert_same_tree(tport.branch_to_tree(got.dino), jax.device_get(want.dino_params))
    pts, shot_f, nrm, desc, idx = _inputs(np.random.default_rng(1))
    t = torch.from_numpy
    with torch.no_grad():
        out_s = got.shot(t(pts), t(shot_f), t(nrm), t(idx))
        out_d = got.dino(t(pts), t(desc), t(idx))
        ref_s = shot(t(pts), t(shot_f), t(nrm), t(idx).long())
        ref_d = dino(t(pts), t(desc), t(idx).long())
    np.testing.assert_allclose(out_s.logits.numpy(), ref_s[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(out_d.logits.numpy(), ref_d[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(out_d.scales.numpy(), ref_d[1].numpy(), atol=2e-4)


def _dinov2_state_dict(cfg, seed=0):
    """A state dict in facebookresearch/dinov2's key layout, N(0, 0.02)
    matrices and N(0, 1) vectors, layer scale 0.5 so the blocks move the
    stream."""
    g = torch.Generator().manual_seed(seed)
    d, p, hidden = cfg.embed_dim, cfg.patch_size, int(cfg.embed_dim * cfg.mlp_ratio)

    def r(*shape, s=0.02):
        return torch.randn(*shape, generator=g) * s

    sd = {"patch_embed.proj.weight": r(d, 3, p, p), "patch_embed.proj.bias": r(d),
          "cls_token": r(1, 1, d), "pos_embed": r(1, 1 + cfg.pretrain_grid ** 2, d),
          "norm.weight": 1 + r(d, s=0.1), "norm.bias": r(d, s=0.1), "mask_token": r(1, d)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": 1 + r(d, s=0.1), b + "norm1.bias": r(d, s=0.1),
                   b + "attn.qkv.weight": r(3 * d, d), b + "attn.qkv.bias": r(3 * d),
                   b + "attn.proj.weight": r(d, d), b + "attn.proj.bias": r(d),
                   b + "ls1.gamma": torch.full((d,), 0.5), b + "norm2.weight": 1 + r(d, s=0.1),
                   b + "norm2.bias": r(d, s=0.1), b + "mlp.fc1.weight": r(hidden, d),
                   b + "mlp.fc1.bias": r(hidden), b + "mlp.fc2.weight": r(d, hidden),
                   b + "mlp.fc2.bias": r(d), b + "ls2.gamma": torch.full((d,), 0.5)})
    return sd


def test_dinov2_pth_ports_as_jax_does(tmp_path):
    """embed 1024 (the dino branch's descriptor width), depth 1, 16 heads,
    a 4 x 4 position grid, f32: the port's tree equals JAX's leaf for leaf
    (from the dict and from a `{"model": sd}` .pth); the port's ViT (K1's
    plain version) and JAX's (its Pallas kernel in interpret mode) give the
    same tokens within 2e-3 on a 56 x 70 image; the patch embedding equals
    the convolution it came from; a missing file is None."""
    tcfg = tdino.ViTConfig(embed_dim=1024, depth=1, num_heads=16, pretrain_grid=4, compute_dtype="float32")
    jcfg = jdino.ViTConfig(embed_dim=1024, depth=1, num_heads=16, pretrain_grid=4, compute_dtype="float32",
                           attn_impl="pallas", attn_block_q=128)
    sd = _dinov2_state_dict(tcfg)
    tree = tdino.port_torch_state_dict(sd, tcfg)
    _assert_same_tree(tree, jdino.port_torch_state_dict(sd, jcfg))
    torch.save({"model": sd}, tmp_path / "vit.pth")
    _assert_same_tree(tdino.load_dinov2_params(str(tmp_path / "vit.pth"), tcfg), tree)
    assert tdino.load_dinov2_params(str(tmp_path / "missing.pth"), tcfg) is None

    vit = tport.load_vit(tdino.DinoViT(tcfg), tree).eval()
    img = np.random.default_rng(0).uniform(size=(56, 70, 3)).astype(np.float32)
    want = np.asarray(jdino.DinoViT(jcfg).apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(img)))
    with torch.no_grad():
        got = vit(torch.from_numpy(img)).numpy()
        # the patch embedding is the convolution over (3, 14, 14) patches
        x = (torch.from_numpy(img) - torch.from_numpy(tdino.IMAGENET_MEAN)) / torch.from_numpy(tdino.IMAGENET_STD)
        conv = torch.nn.functional.conv2d(x.permute(2, 0, 1)[None], sd["patch_embed.proj.weight"],
                                          sd["patch_embed.proj.bias"], stride=14)[0].permute(1, 2, 0)
        patches = x.reshape(4, 14, 5, 14, 3).transpose(1, 2).reshape(20, 14 * 14 * 3)
        dense = vit.patch_embed(patches).reshape(4, 5, -1)
    assert got.shape == want.shape == (4, 5, 1024)
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(dense.numpy(), conv.numpy(), atol=1e-5)


def _moments(w, fan_in):
    z = np.asarray(w, np.float64).ravel() * np.sqrt(fan_in)
    return np.abs(z).max(), z.std(), np.mean(z ** 4) / np.mean(z ** 2) ** 2


def test_init_draws_flax_lecun_normal():
    """Kernels of a 1000 -> 1000 Dense from `init_flax_` and from
    `DinoViT.init_random`, against `flax.linen.Dense(...).init`: |w| *
    sqrt(fan_in) stays within 2 / 0.8796 = 2.274 (a plain normal would
    reach about 4.9 in 10^6 draws) and comes within 0.05 of it, the standard
    deviation of w * sqrt(fan_in) is 1 within 0.01 in each, and the kurtosis
    (2.36 truncated, 3 plain) agrees with flax's within 0.03. Biases zero."""
    bound = 2.0 / 0.87962566103423978
    kernel = np.asarray(fnn.Dense(1000).init(jax.random.key(0), jnp.zeros((1, 1000)))["params"]["kernel"])
    f_max, f_std, f_kurt = _moments(kernel, 1000)
    dense = Dense(1000, 1000)
    init_flax_(torch.nn.Sequential(dense), torch.Generator().manual_seed(0))
    vit = tdino.DinoViT(tdino.ViTConfig(embed_dim=1000, depth=1, num_heads=10, pretrain_grid=2))
    vit.init_random(torch.Generator().manual_seed(1))
    for w, b in ((dense.weight, dense.bias), (vit.blocks[0].attn.proj.weight, vit.blocks[0].attn.proj.bias)):
        t_max, t_std, t_kurt = _moments(w.detach().numpy(), 1000)
        assert bound - 0.05 < t_max <= bound * (1 + 1e-6) and bound - 0.05 < f_max <= bound * (1 + 1e-6)
        assert abs(t_std - 1) < 0.01 and abs(f_std - 1) < 0.01
        assert abs(t_kurt - f_kurt) < 0.03
        assert not b.detach().any()
    fc1 = vit.blocks[0].mlp_fc1.weight.detach().numpy()
    assert np.abs(fc1).max() * np.sqrt(1000) <= bound * (1 + 1e-6)
