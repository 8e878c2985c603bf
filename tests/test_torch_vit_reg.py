"""DINOv2 ViT-g/14 with registers in the port (`models/dinov2.py`,
`ViTConfig(ffn="swiglu", num_registers=4)`) against its plain reference
(`cppf2_torch/reference/dinov2_reg.py`) at a small size on the CPU: 128 wide,
two heads of 64, two blocks, a pretrain grid of 4 resized to a crop's 6 x 5
patches, every leaf drawn from one seed at a trained ViT's scales. Also the
release's checkpoint layout, the weight carry both ways, the gate's plain
version, the refusals, the visual stages' counters, and that the default
block is the parent's. Two tests run the gate kernel (K5) on a CUDA card and
are skipped without one.

The JAX package has no such block, so nothing here is compared with it and
this file imports no JAX.
"""

import math

import numpy as np
import pytest
import torch

from cppf2_torch.eval import driver
from cppf2_torch.models import dinov2
from cppf2_torch.models.dinov2 import DinoViT, ViTConfig
from cppf2_torch.models.porting import load_vit, vit_to_tree
from cppf2_torch.ops import _build, swiglu
from cppf2_torch.reference import dinov2_reg
from cppf2_torch.utils import profiling

SMALL = dict(embed_dim=128, depth=2, num_heads=2, pretrain_grid=4)
REG = dict(SMALL, ffn="swiglu", num_registers=4)
HW = (6 * 14, 5 * 14)   # a crop off the pretrain grid: the position grid is resized to 6 x 5


def _draw(module: torch.nn.Module, seed: int) -> dict:
    """Every leaf of `module` at a trained ViT's orders of magnitude, from
    one CPU generator: matrices N(0, 1 / fan_in), LayerNorm gains 1 + 0.1
    N(0, 1), layer scales 0.05 + 0.2 |N(0, 1)|, biases, tokens and position
    embeddings 0.02 N(0, 1). Returns the drawn state, float32."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in module.named_parameters():
        x = torch.randn(p.shape, generator=gen)
        if p.dim() == 2 and name.endswith(".weight"):
            x = x * math.sqrt(1.0 / p.shape[1])
        elif name.endswith(("ls1", "ls2")):
            x = 0.05 + 0.2 * x.abs()
        elif "norm" in name and name.endswith(".weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.02 * x
        out[name] = x
    return out


def _pair(compute_dtype: str, attn_impl: str, seed: int = 3):
    """The port's ViT and the reference, loaded with one drawn state and,
    in bfloat16, stored as served: matrices, class token, registers and
    position embedding in bfloat16 (`cast_for_inference`)."""
    port = DinoViT(ViTConfig(**REG, compute_dtype=compute_dtype, attn_impl=attn_impl)).eval()
    state = _draw(port, seed)
    port.load_state_dict(state)
    ref = dinov2_reg.DinoViTReg(dinov2_reg.RegConfig(**{k: v for k, v in REG.items() if k != "ffn"},
                                                     compute_dtype=compute_dtype)).eval()
    ref.load_state_dict(state)
    if compute_dtype == "bfloat16":
        port.cast_for_inference()
        with torch.no_grad():
            for prm in (ref.cls_token, ref.register_tokens, ref.pos_embed):
                prm.data = prm.data.to(torch.bfloat16)
    return port, ref


def _image(seed: int = 0, lead=()):
    return torch.from_numpy(np.random.default_rng(seed).uniform(size=(*lead, *HW, 3)).astype(np.float32))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("attn_impl,compute_dtype,rel_tol", [
    ("hbm", "float32", 0.0),
    ("hbm", "bfloat16", 0.0),
    ("kernel", "float32", 1e-3),
    ("kernel", "bfloat16", 4e-3),
])
def test_the_port_matches_the_reference(attn_impl, compute_dtype, rel_tol):
    """The normed patch tokens of one crop, port against reference. The
    "hbm" route takes the reference's operations in the reference's order,
    the gate's plain formula included: equal to the bit in both types. The
    "kernel" route's attention on the CPU is K1's plain version, which rounds
    q, k and v to bfloat16 and takes the logits in float32, against the
    reference's float32 or bfloat16 logits: relative L2 gaps of 2.1e-4 and
    7.6e-4 at four seeds, held under 1e-3 and 4e-3 (2^-8, bfloat16's
    relative step)."""
    port, ref = _pair(compute_dtype, attn_impl)
    img = _image()
    with torch.no_grad():
        got, want = port(img), ref(img)
    assert got.shape == want.shape == (6, 5, 128) and got.dtype == torch.float32
    if rel_tol == 0.0:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        assert 0.0 < _rel(got, want) < rel_tol


def test_the_output_leaves_out_the_registers_which_reach_the_patches():
    """A stack of two crops gives two 6 x 5 grids, the class token and the
    four registers left out; each crop's grid is its own forward's; a moved
    register token moves every patch's output."""
    port, _ = _pair("float32", "hbm")
    imgs = _image(1, lead=(2,))
    with torch.no_grad():
        both = port(imgs)
        one = port(imgs[1])
        assert both.shape == (2, 6, 5, 128)
        torch.testing.assert_close(both[1], one, rtol=1e-5, atol=1e-5)
        port.register_tokens[2] += 0.5
        moved = port(imgs[1])
    assert torch.all(torch.linalg.vector_norm(moved - one, dim=-1) > 0)


def _release_state(cfg: ViTConfig, seed: int) -> dict:
    """A state dict in the release's layout (facebookresearch/dinov2:
    `patch_embed.proj` a convolution, `mlp.w12` / `mlp.w3`, `ls*.gamma`,
    (1, R, D) registers, (1, 1 + g^2, D) position embedding), drawn."""
    gen = torch.Generator().manual_seed(seed)
    d, p, r, g = cfg.embed_dim, cfg.patch_size, cfg.num_registers, cfg.pretrain_grid
    h = dinov2.swiglu_hidden(cfg)

    def draw(*shape, scale=0.02):
        return scale * torch.randn(shape, generator=gen)

    sd = {"patch_embed.proj.weight": draw(d, 3, p, p, scale=0.05), "patch_embed.proj.bias": draw(d),
          "cls_token": draw(1, 1, d), "register_tokens": draw(1, r, d),
          "pos_embed": draw(1, 1 + g * g, d), "norm.weight": 1 + draw(d), "norm.bias": draw(d)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for name, (rows, cols) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                                   ("mlp.w12", (2 * h, d)), ("mlp.w3", (d, h))):
            sd[b + name + ".weight"] = draw(rows, cols, scale=cols ** -0.5)
            sd[b + name + ".bias"] = draw(rows)
        for name in ("norm1", "norm2"):
            sd[b + name + ".weight"] = 1 + draw(d, scale=0.1)
            sd[b + name + ".bias"] = draw(d)
        sd[b + "ls1.gamma"] = 0.1 + draw(d, scale=0.05).abs()
        sd[b + "ls2.gamma"] = 0.1 + draw(d, scale=0.05).abs()
    return sd


def test_the_release_layout_gives_the_forward_of_its_tensors_loaded_directly(tmp_path):
    """`port_torch_state_dict` of a release-layout state dict (and
    `load_dinov2_params` of it saved as a `.pth`) into the port, against the
    same tensors copied into the port's modules by hand: the convolution as
    a product over (py, px, channel), w12's rows in the release's order (the
    silu half first). Equal forwards, to the bit."""
    cfg = ViTConfig(**REG, attn_impl="hbm")
    sd = _release_state(cfg, 5)
    ported = load_vit(DinoViT(cfg).eval(), dinov2.port_torch_state_dict(sd, cfg))
    torch.save({"model": sd}, tmp_path / "vitg14_reg.pth")
    from_file = load_vit(DinoViT(cfg).eval(), dinov2.load_dinov2_params(str(tmp_path / "vitg14_reg.pth"), cfg))
    direct = DinoViT(cfg).eval()
    d = cfg.embed_dim
    state = {"patch_embed.weight": sd["patch_embed.proj.weight"].permute(0, 2, 3, 1).reshape(d, -1),
             "patch_embed.bias": sd["patch_embed.proj.bias"], "cls_token": sd["cls_token"][0],
             "register_tokens": sd["register_tokens"][0], "pos_embed": sd["pos_embed"][0],
             "norm.weight": sd["norm.weight"], "norm.bias": sd["norm.bias"]}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for mine, theirs in (("attn.qkv", "attn.qkv"), ("attn.proj", "attn.proj"),
                             ("mlp_w12", "mlp.w12"), ("mlp_w3", "mlp.w3"), ("norm1", "norm1"),
                             ("norm2", "norm2")):
            state[b + mine + ".weight"] = sd[b + theirs + ".weight"]
            state[b + mine + ".bias"] = sd[b + theirs + ".bias"]
        state[b + "ls1"], state[b + "ls2"] = sd[b + "ls1.gamma"], sd[b + "ls2.gamma"]
    direct.load_state_dict(state)
    img = _image(2)
    with torch.no_grad():
        want = direct(img)
        torch.testing.assert_close(ported(img), want, rtol=0, atol=0)
        torch.testing.assert_close(from_file(img), want, rtol=0, atol=0)


def test_the_weight_carry_and_the_backbone_files_keep_the_block(tmp_path):
    """`vit_to_tree` carries `register_tokens`, `mlp_w12` and `mlp_w3` (the
    blocks stacked), `load_vit` takes them back, and `save_backbone` /
    `load_backbone` keep the config's `ffn` and `num_registers`: the same
    forward to the bit each way."""
    port, _ = _pair("float32", "hbm")
    tree = vit_to_tree(port)
    blocks = tree["params"]["blocks"]
    assert tree["params"]["register_tokens"].shape == (4, 128)
    assert blocks["mlp_w12"]["kernel"].shape == (2, 128, 2 * 344)   # swiglu_hidden: 344 at 128 wide
    assert blocks["mlp_w3"]["kernel"].shape == (2, 344, 128)
    assert "mlp_fc1" not in blocks
    back = load_vit(DinoViT(port.cfg).eval(), tree)
    saved = dinov2.save_backbone(str(tmp_path / "bb" / "vitg"), port, stride=8)
    loaded, cfg, stride, _ = dinov2.load_backbone(saved[:-len(".msgpack")], device="cpu",
                                                  attn_impl="hbm", compute_dtype="float32")
    assert (cfg.ffn, cfg.num_registers, stride) == ("swiglu", 4, 8)
    img = _image(3)
    with torch.no_grad():
        want = port(img)
        torch.testing.assert_close(back(img), want, rtol=0, atol=0)
        torch.testing.assert_close(loaded.eval()(img), want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_gate_on_the_cpu_is_the_reference_formula_to_the_bit(dtype):
    """`swiglu.gate` of a CPU tensor is its plain version, which is the
    reference's formula: silu of the first half times the second in float32,
    rounded once. Odd row counts and a width that is no multiple of 8."""
    x = (3 * torch.randn((3, 7, 2 * 348), generator=torch.Generator().manual_seed(1))).to(dtype)
    got = swiglu.gate(x)
    assert got.shape == (3, 7, 348) and got.dtype == dtype
    torch.testing.assert_close(got, dinov2_reg.gate(x), rtol=0, atol=0)
    torch.testing.assert_close(swiglu.gate_plain(x), got, rtol=0, atol=0)
    a, b = x[..., :348].double(), x[..., 348:].double()
    torch.testing.assert_close(got.double(), a * torch.sigmoid(a) * b,
                               rtol=2 ** -7 if dtype == torch.bfloat16 else 1e-6, atol=1e-6)


def test_the_gate_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="2h"):
        swiglu.gate(torch.zeros(4, 7))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        swiglu.gate(torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(RuntimeError, match="no backward"):
        swiglu.gate(torch.zeros(4, 8, requires_grad=True))


@pytest.mark.parametrize("make,field", [
    (lambda: ViTConfig(quant="int8", ffn="swiglu"), "ffn"),
    (lambda: ViTConfig(quant="int8", num_registers=4), "num_registers"),
    (lambda: ViTConfig(ffn="geglu"), "ffn"),
    (lambda: DinoViT(ViTConfig(**REG)).init_random(seed=1), "ffn"),
    (lambda: DinoViT(ViTConfig(**SMALL, num_registers=4)).init_random(seed=1), "num_registers"),
    (lambda: DinoViT(ViTConfig(**REG)).quantize_(), "ffn"),
    (lambda: dinov2.init_tree(ViTConfig(**SMALL, num_registers=2), 0), "num_registers"),
    (lambda: dinov2.DinoFeatureExtractor(cfg=ViTConfig(**REG), quant="int8", device="cpu"), "ffn"),
], ids=["int8_swiglu", "int8_registers", "unknown_ffn", "seed_swiglu", "seed_registers",
        "quantize_swiglu", "init_tree_registers", "int8_extractor"])
def test_a_block_the_jax_package_lacks_is_refused_by_name(make, field):
    with pytest.raises(ValueError, match=field):
        make()


def _vitl_names_and_shapes(depth: int):
    """The parent's ViT-L parameters, written out."""
    out = [("cls_token", (1, 1024)), ("pos_embed", (1370, 1024)),
           ("patch_embed.weight", (1024, 588)), ("patch_embed.bias", (1024,))]
    for i in range(depth):
        b = f"blocks.{i}."
        out += [(b + "ls1", (1024,)), (b + "ls2", (1024,)),
                (b + "norm1.weight", (1024,)), (b + "norm1.bias", (1024,)),
                (b + "norm2.weight", (1024,)), (b + "norm2.bias", (1024,)),
                (b + "attn.qkv.weight", (3072, 1024)), (b + "attn.qkv.bias", (3072,)),
                (b + "attn.proj.weight", (1024, 1024)), (b + "attn.proj.bias", (1024,)),
                (b + "mlp_fc1.weight", (4096, 1024)), (b + "mlp_fc1.bias", (4096,)),
                (b + "mlp_fc2.weight", (1024, 4096)), (b + "mlp_fc2.bias", (1024,))]
    return out + [("norm.weight", (1024,)), ("norm.bias", (1024,))]


def test_vitl_built_with_the_defaults_has_the_parents_parameters():
    with torch.device("meta"):
        model = DinoViT(dinov2.VIT_L14)
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == _vitl_names_and_shapes(24)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_the_default_block_is_the_parents_to_the_bit(compute_dtype):
    """The default config (GELU, no registers) at ViT-L's widths, two blocks,
    against the frozen copy of the parent's plain ViT that the benchmark's
    reference keeps (`perfbench/reference/dinov2.py`) on one drawn state:
    the same output to the bit, on the "hbm" route the copy has."""
    from perfbench.reference import dinov2 as frozen

    kw = dict(depth=2, pretrain_grid=4, compute_dtype=compute_dtype, attn_impl="hbm")
    port = DinoViT(ViTConfig(**kw)).eval()
    state = _draw(port, 9)
    port.load_state_dict(state)
    parent = frozen.DinoViT(frozen.ViTConfig(**kw)).eval()
    parent.load_state_dict(state)
    img = _image(4)
    with torch.no_grad():
        torch.testing.assert_close(port(img), parent(img), rtol=0, atol=0)


@pytest.mark.parametrize("reg", [True, False], ids=["swiglu_registers", "gelu"])
def test_the_visual_stages_count_tokens_and_gate_elements(reg):
    """A frame-wide ViT stage of three crops and an instance visual stage on
    both routes count into the open frame record: tokens of 8 x 8 patches,
    the class token and the registers, a crop each; gate elements depth x
    tokens x 344 for the SwiGLU block, none for the GELU one."""
    cfg = ViTConfig(**(REG if reg else SMALL))
    vit = DinoViT(cfg).eval()
    vit.load_state_dict(_draw(vit, 1))
    ext = dinov2.DinoFeatureExtractor(cfg=cfg, stride=8, device="cpu")
    ext.model.load_state_dict(_draw(ext.model, 1))
    ext._cast()
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    masks = np.zeros((3, 96, 128), bool)
    masks[:, 20:60, 30:80] = True
    pixel_yx = torch.tensor([[30, 40], [50, 70]])
    per_crop = 64 + 1 + cfg.num_registers
    per_ext_crop = 32 * 32 + 1 + cfg.num_registers   # the host's 256 crop at stride 8
    with profiling.frame_span("dispatch"):
        pass
    with torch.no_grad(), profiling.frame_span("dispatch"):
        driver._vit_stage(vit, 8, 64, (1, 2), torch.from_numpy(rgb), torch.from_numpy(masks))
        driver._instance_visual(rgb, masks[0], torch.from_numpy(masks[0]), pixel_yx, torch.device("cpu"),
                                vit, None, 8, 64)
        driver._instance_visual(rgb, masks[0], torch.from_numpy(masks[0]), pixel_yx, torch.device("cpu"),
                                None, ext, 8, 256)
    c = profiling.frames()[-1].counters
    tokens = 4 * per_crop + per_ext_crop
    assert c["vit_tokens"] == tokens
    assert c["gate_elems"] == (2 * tokens * 344 if reg else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h", [(1029, 4096), (1031, 4096)], ids=["crop", "odd_rows"])
def test_the_gate_kernel_matches_the_plain_formula_on_the_card(rows, h):
    """K5 against the plain formula on the card, in bfloat16 within one ulp
    (both take silu and the product in float32; the card's `expf` and
    PyTorch's may part in the last float32 bit, which can move a rounding
    to bfloat16 by one step), and in float32 within 2 ulps; the launches
    counted. Shapes: a ViT-g crop's 1029 tokens at h = 4096 and an odd row
    count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gate kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(rows)
    for dtype in (torch.bfloat16, torch.float32):
        x = (4 * torch.randn((rows, 2 * h), generator=gen, device=dev)).to(dtype)
        n0 = _build.launched("swiglu")
        got = swiglu.gate(x)
        torch.cuda.synchronize()
        assert _build.launched("swiglu") == n0 + 1
        want = swiglu.gate_plain(x)
        assert got.shape == want.shape == (rows, h) and got.dtype == dtype
        eps = 2 ** -7 if dtype == torch.bfloat16 else 2 * 2 ** -23
        torch.testing.assert_close(got.float(), want.float(), rtol=eps, atol=1e-30)


@pytest.mark.gpu
def test_the_gate_kernel_refuses_a_misaligned_input_on_the_card():
    """The kernel moves whole 16-byte vectors: a half that is not a whole
    number of them, or an input at an address off 16 bytes, is refused, and
    nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gate kernel has no CPU mode")
    dev = torch.device("cuda")
    skewed = torch.zeros(2 * 2 * 4096 + 1, dtype=torch.bfloat16, device=dev)[1:].view(2, 2 * 4096)
    n0 = _build.launched("swiglu")
    for x in (torch.zeros((3, 2 * 348), dtype=torch.bfloat16, device=dev), skewed):
        with pytest.raises(ValueError, match="16-byte"):
            swiglu.gate(x)
    assert _build.launched("swiglu") == n0
