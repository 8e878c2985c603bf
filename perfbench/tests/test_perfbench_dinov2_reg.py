"""The `dinov2_reg` backbone (DINOv2 ViT-g/14 with registers): its leaves,
tokens and FLOPs at the configuration's widths, its plain reference against
the program's own plain reference, the gate kernel's roofline reader on a
synthetic trace, and a whole run of the new cell at a small size on the CPU."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spec, trace
from perfbench.metrics import _program
from perfbench.scenes.generate import frame_set

CELL = "s8-vitg14reg-real275-eval"
CONFIG = "cppf2-vitg14reg-s8"
SEED = 2 ** 31 + 29


def _config():
    return copy.deepcopy(spec.config(spec.benchmark(), CONFIG))


def _vitg14reg_leaves():
    """ViT-g/14-reg's leaves written out: names, shapes and kinds, in the
    order the weights are drawn (1536 wide, w12 2 x 4096, 4 registers)."""
    out = [("patch_embed.weight", (1536, 588), "matrix"), ("patch_embed.bias", (1536,), "bias"),
           ("cls_token", (1, 1536), "embed"), ("register_tokens", (4, 1536), "embed"),
           ("pos_embed", (1370, 1536), "embed")]
    for i in range(40):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (1536,), "gain"), (b + "norm1.bias", (1536,), "bias"),
                (b + "norm2.weight", (1536,), "gain"), (b + "norm2.bias", (1536,), "bias"),
                (b + "attn.qkv.weight", (4608, 1536), "matrix"), (b + "attn.qkv.bias", (4608,), "bias"),
                (b + "attn.proj.weight", (1536, 1536), "matrix"), (b + "attn.proj.bias", (1536,), "bias"),
                (b + "mlp_w12.weight", (8192, 1536), "matrix"), (b + "mlp_w12.bias", (8192,), "bias"),
                (b + "mlp_w3.weight", (1536, 4096), "matrix"), (b + "mlp_w3.bias", (1536,), "bias"),
                (b + "ls1", (1536,), "layerscale"), (b + "ls2", (1536,), "layerscale")]
    return out + [("norm.weight", (1536,), "gain"), ("norm.bias", (1536,), "bias")]


def test_the_leaves_of_the_configuration():
    vit = _config()["vit"]
    assert spec.arch(vit) == "dinov2_reg"
    leaves = spec.backbone("dinov2_reg").leaves(vit)
    assert leaves == _vitg14reg_leaves()
    n = sum(torch.Size(s).numel() for _, s, _ in leaves)
    assert n / 1e9 == pytest.approx(1.136, abs=5e-3)   # 1.13 B parameters


def test_the_tokens_and_flops():
    cfg = _config()
    bb = spec.backbone(spec.arch(cfg["vit"]))
    t = bb.tokens(cfg["vit"], cfg["crop"] // cfg["stride"])
    assert t == 1029
    d, h = 1536, 4096
    assert bb.flops(cfg["vit"], t) == 40 * (2 * t * (4 * d * d + 3 * d * h) + 4 * t * t * d)
    assert round(bb.flops(cfg["vit"], t) / 1e12, 2) == 2.59


@pytest.mark.parametrize("vit,key", [
    ({"ffn": "gelu"}, "ffn"), ({"registers": 4}, "registers")], ids=["gelu", "unknown_key"])
def test_a_group_the_backbone_cannot_build_is_refused(vit, key):
    group = dict(_config()["vit"], **vit)
    bb = spec.backbone("dinov2_reg")
    with pytest.raises(ValueError, match=key):
        bb.leaves(group)
    with pytest.raises(ValueError, match=key):
        bb.reference(group, {"vit": "bfloat16"}, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_benchmarks_reference_is_the_programs_to_the_bit(dtype):
    """`perfbench/reference/dinov2_reg.py` (built from the reference's Dense
    and attention) against `cppf2_torch/reference/dinov2_reg.py` on the same
    drawn tensors, 128 wide, two blocks, a 37 -> 6 x 5 position resize."""
    from cppf2_torch.reference import dinov2_reg as program_ref
    from perfbench import weights

    vit = dict(_config()["vit"], embed_dim=128, num_heads=2, depth=2, pretrain_grid=37)
    bench = spec.backbone("dinov2_reg").reference(vit, {"vit": dtype}, "cpu")
    tensors = weights.vit_tensors(vit, SEED, "cpu")
    weights.load_vit(bench, {k: t.float() for k, t in tensors.items()})
    plain = program_ref.DinoViTReg(program_ref.RegConfig(
        embed_dim=128, num_heads=2, depth=2, pretrain_grid=37, num_registers=4,
        compute_dtype=dtype)).eval()
    plain.load_state_dict({k: t.float() for k, t in tensors.items()})
    with torch.no_grad():
        for p in (plain.cls_token, plain.register_tokens, plain.pos_embed):
            p.data = p.data.to(getattr(torch, dtype))
    img = torch.rand((6 * 14, 5 * 14, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = bench(img), plain(img)
    assert got.shape == (6, 5, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _rec(traced, gate_elems, start_us, end_us):
    return SimpleNamespace(traced=traced, spans={}, counters={"gate_elems": gate_elems},
                           start_ns=start_us * 1e3, end_ns=end_us * 1e3,
                           intervals=[("dispatch", None, start_us * 1e3, end_us * 1e3)])


def test_the_gate_roofline_from_a_synthetic_trace(monkeypatch):
    """Two traced frames gating 1e8 and 2e8 elements (the untraced one's 5e9
    left out), K5 running 0.3 ms in all: 6 bytes x 3e8 at 3.35 TB/s over
    0.3 ms. Without a K5 launch, or without the program's counters, None."""
    t0 = 1.7e12
    recs = [_rec(False, 5e9, t0 - 900, t0 - 800), _rec(True, 1e8, t0 + 100, t0 + 300),
            _rec(True, 2e8, t0 + 500, t0 + 700)]
    monkeypatch.setattr(_program, "frame_records", lambda: recs)
    host = [(100.0, 300.0, "perfbench.dispatch"), (500.0, 700.0, "perfbench.dispatch")]
    acts = [trace.Activity("void swiglu_gate_kernel<__nv_bfloat16, 8>(...)", 150.0, 250.0, "perfbench.vit"),
            trace.Activity("void swiglu_gate_kernel<__nv_bfloat16, 8>(...)", 550.0, 750.0, "perfbench.vit"),
            trace.Activity("mha_fwd_kernel", 250.0, 260.0, "perfbench.vit")]
    ctx = SimpleNamespace(trace=trace.Trace((0.0, 1000.0), acts, host, 1.0), frames=2)
    read = spec.reader("gate_roofline.vitg")
    assert read(ctx) == pytest.approx(100.0 * 6 * 3e8 / 3.35e12 / 300e-6)
    no_k5 = SimpleNamespace(trace=trace.Trace((0.0, 1000.0), acts[2:], host, 1.0), frames=2)
    assert read(no_k5) is None
    monkeypatch.setattr(_program, "frame_records", lambda: None)
    assert read(ctx) is None


@pytest.fixture(scope="module")
def small_cell():
    """The new cell at `test_perfbench_faults.py`'s size: a two-block ViT of
    the dinov2_reg architecture 128 wide (two heads of 64, 4 registers,
    SwiGLU), 512 points, 2,000 pairs, 5 Adam steps, three frames that each
    hold a near laptop (a single) beside one grouped instance."""
    threads, onednn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(4)
    torch.backends.mkldnn.enabled = False
    try:
        bench = spec.benchmark()
        cell = spec.cell(bench, CELL)
        cfg = _config()
        cfg["pipeline"].update(n_points=512, num_pairs=2000, opt_steps=5)
        cfg["vit"].update(embed_dim=128, num_heads=2, depth=2, pretrain_grid=4)
        mix = dict(spec.traffic(cell["traffic"]), frames=3, instances=[2], tierless_frames=3,
                   check_frames=3, check_tierless=3)
        yield bench, cfg, mix, spec.limits(CELL), frame_set(mix, SEED, "cpu")
    finally:
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = onednn


def test_a_small_run_of_the_cell_is_correct(small_cell, monkeypatch):
    bench, cfg, mix, limits, frames = small_cell
    monkeypatch.setattr(harness, "frame_set", lambda m, s, d: frames)
    out = harness.run_cell(CELL, cfg, mix, limits, spec.metrics_of(bench, CELL, "end_to_end"),
                           spec.metrics_of(bench, CELL, "per_layer"), SEED, 0.0, False, "cpu",
                           time.perf_counter())
    assert out["correct"] is True, out["checked"]
    assert set(out["checked"]) == set(limits)
    assert set(out["metrics"]) == {"setup_s", "instances_per_s"}
