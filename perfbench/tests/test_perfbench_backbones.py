"""A configuration names its backbone: `perfbench/backbones/<arch>.py` is
found by name, the `dinov2` file gives today's leaves, tokens and FLOPs, and a
`vit` key that either side cannot build is refused before any work."""

import copy
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import harness, spec, weights
from perfbench.reference.checkpoints import load_params_msgpack
from perfbench.reference.pose import Reference
from perfbench.system import System

CONFIGS = ("cppf2-vitl14-s8", "cppf2-vitl14-s4")


def _config(name):
    return copy.deepcopy(spec.config(spec.benchmark(), name))


def _vitl14_leaves():
    """ViT-L/14's leaves written out: names, shapes and kinds, in the order
    the weights are drawn."""
    out = [("patch_embed.weight", (1024, 588), "matrix"), ("patch_embed.bias", (1024,), "bias"),
           ("cls_token", (1, 1024), "embed"), ("pos_embed", (1370, 1024), "embed")]
    for i in range(24):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (1024,), "gain"), (b + "norm1.bias", (1024,), "bias"),
                (b + "norm2.weight", (1024,), "gain"), (b + "norm2.bias", (1024,), "bias"),
                (b + "attn.qkv.weight", (3072, 1024), "matrix"), (b + "attn.qkv.bias", (3072,), "bias"),
                (b + "attn.proj.weight", (1024, 1024), "matrix"), (b + "attn.proj.bias", (1024,), "bias"),
                (b + "mlp_fc1.weight", (4096, 1024), "matrix"), (b + "mlp_fc1.bias", (4096,), "bias"),
                (b + "mlp_fc2.weight", (1024, 4096), "matrix"), (b + "mlp_fc2.bias", (1024,), "bias"),
                (b + "ls1", (1024,), "layerscale"), (b + "ls2", (1024,), "layerscale")]
    return out + [("norm.weight", (1024,), "gain"), ("norm.bias", (1024,), "bias")]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_dinov2_leaves_of_each_configuration(name):
    vit = _config(name)["vit"]
    assert spec.arch(vit) == "dinov2"
    assert spec.backbone("dinov2").leaves(vit) == _vitl14_leaves()


@pytest.mark.parametrize("name,tokens", [("cppf2-vitl14-s8", 1025), ("cppf2-vitl14-s4", 4097)])
def test_the_dinov2_tokens_and_flops(name, tokens):
    cfg = _config(name)
    bb = spec.backbone(spec.arch(cfg["vit"]))
    assert bb.tokens(cfg["vit"], cfg["crop"] // cfg["stride"]) == tokens
    per_block = 24 * tokens * 1024 ** 2 + 4 * tokens ** 2 * 1024
    assert bb.flops(cfg["vit"], tokens) == 24 * per_block
    if tokens == 1025:
        assert bb.flops(cfg["vit"], tokens) / 1e12 == pytest.approx(0.7229, rel=1e-3)


def test_a_backbone_file_is_found_by_name_and_a_missing_one_fails(tmp_path):
    here = tmp_path / "perfbench"
    (here / "backbones").mkdir(parents=True)
    (here / "backbones" / "toy-vit.py").write_text(
        "def tokens(vit, grid):\n    return grid * grid + vit['registers'] + 1\n")
    assert spec.arch({"arch": "toy-vit"}) == "toy-vit"
    assert spec.backbone("toy-vit", here).tokens({"registers": 4}, 32) == 1029
    with pytest.raises(FileNotFoundError, match="no backbone 'vitg14'.*toy-vit"):
        spec.backbone("vitg14", here)


def test_the_vit_draws_follow_the_backbones_leaves():
    vit = dict(_config("cppf2-vitl14-s8")["vit"], depth=1, pretrain_grid=4)
    drawn = weights.vit_tensors(vit, 2 ** 31 + 5, "cpu")
    assert {n: tuple(t.shape) for n, t in drawn.items()} == \
        {n: s for n, s, _ in spec.backbone("dinov2").leaves(vit)}


@pytest.mark.parametrize("key", ["ffn", "registers"])
def test_a_vit_key_either_side_cannot_build_is_refused(key, monkeypatch):
    cfg = _config("cppf2-vitl14-s8")
    cfg["vit"][key] = "swiglu" if key == "ffn" else 4
    with pytest.raises(ValueError, match=key):
        System(cfg, 1, "cpu")
    bb = spec.backbone("dinov2")
    with pytest.raises(ValueError, match=key):
        bb.reference(cfg["vit"], cfg["precision"], "cpu")
    with pytest.raises(ValueError, match=key):
        bb.leaves(cfg["vit"])

    def no_setup(*a):
        raise AssertionError("set-up began")
    monkeypatch.setattr(harness, "frame_set", no_setup)
    with pytest.raises(ValueError, match=key):
        harness.run_cell("s8-real275-eval", cfg, {}, {}, [], [], 1, 0.0, False, "cpu",
                         time.perf_counter())


def test_a_key_the_port_has_but_the_reference_does_not_is_refused_by_the_hook():
    vit = dict(_config("cppf2-vitl14-s8")["vit"], quant="int8")
    with pytest.raises(ValueError, match="quant"):
        spec.backbone("dinov2").reference(vit, {"vit": "bfloat16"}, "cpu")


def test_the_visual_branch_follows_the_backbones_width():
    tree = load_params_msgpack(str(spec.ROOT / "ckpts_r3" / "dino" / "mug" / "params.msgpack"))
    assert weights.visual_branch_tree(tree, 1024, 7) is tree
    wide = weights.visual_branch_tree(tree, 384, 7)
    p, w = tree.get("params", tree), wide.get("params", wide)
    assert w["desc_transform"]["kernel"].shape == (384, 256)
    assert w["desc_transform"]["kernel"].dtype == np.float32
    assert p["desc_transform"]["kernel"].shape == (1024, 256)     # the checkpoint's is untouched
    assert w["desc_transform"]["bias"] is p["desc_transform"]["bias"]
    assert all(w[k] is p[k] for k in p if k != "desc_transform")
    assert np.std(w["desc_transform"]["kernel"]) == pytest.approx(384 ** -0.5, rel=0.02)
    again = weights.visual_branch_tree(tree, 384, 7).get("params")
    other = weights.visual_branch_tree(tree, 384, 8).get("params")
    assert np.array_equal(again["desc_transform"]["kernel"], w["desc_transform"]["kernel"])
    assert not np.array_equal(other["desc_transform"]["kernel"], w["desc_transform"]["kernel"])


def test_the_program_and_the_reference_serve_one_widened_branch():
    cfg = _config("cppf2-vitl14-s8")
    cfg["vit"].update(embed_dim=384, num_heads=6, depth=1, pretrain_grid=4)
    cfg["categories"] = ["mug", "laptop"]
    seed = 2 ** 31 + 11
    system = System(cfg, seed, "cpu")
    ref = Reference(cfg, seed, "cpu")
    for cat in cfg["categories"]:
        tree = load_params_msgpack(str(spec.ROOT / "ckpts_r3" / "dino" / cat / "params.msgpack"))
        kernel = weights.visual_branch_tree(tree, 384, seed)["params"]["desc_transform"]["kernel"]
        prog, plain = system.models[cat].dino.state_dict(), ref._models(cat)[1].state_dict()
        assert prog.keys() == plain.keys()
        for k in prog:
            torch.testing.assert_close(prog[k].float(), plain[k].float(), rtol=0, atol=0)
        assert np.array_equal(prog["desc_transform.weight"].float().T.numpy(), kernel)


@pytest.mark.parametrize("name,k1,model_flops", [
    ("cppf2-vitl14-s8", 0.00146201108190091, 3743659744512.0),
    ("cppf2-vitl14-s4", 0.023357957379882707, 17352532057344.0)])
def test_the_k1_bound_and_model_flops_at_known_values(name, k1, model_flops):
    # ViT calls of 1, 4, 8 and 1 crops and four instances; the values are
    # those of the count written into the harness for ViT-L/14, to the bit
    cfg = _config(name)
    taps = SimpleNamespace(vit_calls=[1, 4, 8, 1], group_rows=[1, 2, 8], singles=2)
    pipe = SimpleNamespace(num_pairs=50000, vote_levels=4, vote_fine_samples=8, n_points=8192)
    got_k1, _, tokens = harness._bounds(SimpleNamespace(pipe=pipe), cfg, taps)
    assert got_k1 == k1
    items = [("mug", None), ("laptop", None), ("mug", None), ("can", None)]
    assert harness._model_flops(cfg, items, tokens, pipe, 2 ** 31 + 77) == model_flops


def test_the_model_flops_count_the_widened_branch():
    cfg = _config("cppf2-vitl14-s8")
    pipe = SimpleNamespace(n_points=8192, num_pairs=50000)
    items = [("mug", None)]
    base = harness._model_flops(cfg, items, 1025, pipe, 3)
    cfg["vit"].update(embed_dim=384, num_heads=6)
    narrow = harness._model_flops(cfg, items, 1025, pipe, 3)
    vit_gap = 24 * (24 * 1025 * (1024 ** 2 - 384 ** 2) + 4 * 1025 ** 2 * (1024 - 384))
    assert base - narrow == vit_gap + 2 * 8192 * (1024 - 384) * 256
