"""Port's DINOv2 ViT and bbox-crop visual frontend against the JAX package
at a tiny size (embed 64, depth 2, heads 4), weights carried from the JAX
init by `models/porting.py::load_vit`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models.porting import load_vit
from cppf2_tpu.models import dinov2 as jdino


def _cfgs(compute_dtype, attn_impl):
    """Layer scale 1 so attention and MLP move the residual stream."""
    kw = dict(embed_dim=64, depth=2, num_heads=4, pretrain_grid=37, layerscale_init=1.0,
              compute_dtype=compute_dtype)
    return (jdino.ViTConfig(**kw, attn_impl=attn_impl, attn_block_q=128),
            tdino.ViTConfig(**kw))


def _models(compute_dtype, attn_impl, img_hw=(56, 56)):
    jcfg, tcfg = _cfgs(compute_dtype, attn_impl)
    jm = jdino.DinoViT(jcfg)
    params = jm.init(jax.random.key(0), jnp.zeros((*img_hw, 3)))
    tm = load_vit(tdino.DinoViT(tcfg), jax.device_get(params))
    return jm, params, tm


def _img(hw=(70, 84), seed=0):
    return np.random.default_rng(seed).uniform(size=(*hw, 3)).astype(np.float32)


@pytest.mark.parametrize("compute_dtype,attn_impl,atol", [
    ("float32", "pallas", 2e-3),
    ("bfloat16", "pallas", 0.08),
    ("bfloat16", "hbm", 0.1),
])
def test_vit_forward(compute_dtype, attn_impl, atol):
    """Normed tokens (unit-variance rows) of a 70x84 image (5x6 patches, the
    position grid resized 37 -> 5, 6). Attention rounds P and q/k/v to bf16
    on both sides: f32 linears atol 2e-3; bf16 linears round every product
    to 8 bits, atol 0.08 against the Pallas path and 0.1 against the "hbm"
    path, which also rounds the logits to bf16. Mean error a tenth of that."""
    jm, params, tm = _models(compute_dtype, attn_impl)
    img = _img()
    want = np.asarray(jm.apply(params, jnp.asarray(img)))
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (5, 6, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)
    assert np.mean(np.abs(got - want)) < atol / 10


def test_vit_layernorm_gelu_conventions():
    """The traps: LayerNorm epsilon 1e-6 (torch defaults to 1e-5) and the
    tanh GELU (flax's default)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32) * 1e-3)
    ln = tdino.LayerNorm(64)
    want = np.asarray(jax.nn.standardize(jnp.asarray(x.numpy()), epsilon=1e-6))
    np.testing.assert_allclose(ln(x).detach().numpy(), want, atol=2e-4)
    g = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(torch.nn.functional.gelu(g, approximate="tanh").numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(g.numpy()))), atol=1e-6)


@pytest.mark.parametrize("n_out", [32, 16, 5, 48])
def test_pos_embed_resize_matches_jax_image(n_out):
    """The bicubic matrix (Keys a = -0.5, antialiased when downscaling)
    against jax.image.resize on N(0, 1) values: atol 1e-5 for the downscales
    the ViT takes at stride 8 and above; 5e-5 for the 48 upscale, where the
    negative cubic lobes cancel and the two contraction orders differ more."""
    pos = np.random.default_rng(1).normal(size=(37, 37, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(pos), (n_out, n_out, 8), "bicubic"))
    r = tdino.cubic_resize_matrix(37, n_out)
    got = np.einsum("oh,hwc->owc", r, pos)
    got = np.einsum("pw,owc->opc", r, got)
    np.testing.assert_allclose(got, want, atol=1e-5 if n_out < 37 else 5e-5)


def _frame(h=60, w=80, seed=2):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(h, w, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    mask = ((xs - 45) ** 2 / 400 + (ys - 28) ** 2 / 200) < 1
    yy, xx = np.nonzero(mask)
    pix = np.stack([yy, xx], -1)[rng.choice(len(yy), 50)].astype(np.int32)
    return rgb, mask, pix


def test_bbox_crop_descriptors():
    """bbox square -> 32 px crop -> stride 8 (4x4 tokens, a 56 px ViT input,
    so the bilinear resize upscales) -> sampling at cloud pixels; f32
    linears, unit descriptors, atol 2e-3 (the bf16 attention of both sides)."""
    jm, params, tm = _models("float32", "pallas")
    rgb, mask, pix = _frame()
    want = np.asarray(jdino.bbox_crop_descriptors(jm, params, jnp.asarray(rgb), jnp.asarray(mask),
                                                  jnp.asarray(pix), out_size=32, stride=8))
    with torch.no_grad():
        got = tdino.bbox_crop_descriptors(tm, torch.from_numpy(rgb), torch.from_numpy(mask),
                                          torch.from_numpy(pix), out_size=32, stride=8).numpy()
    assert got.shape == (50, 64)
    np.testing.assert_allclose(got, want, atol=2e-3)
    txy_j = np.asarray(jdino.bbox_crop_transform(jnp.asarray(mask), 32))
    txy_t = tdino.bbox_crop_transform(torch.from_numpy(mask), 32).numpy()
    np.testing.assert_array_equal(txy_t, txy_j)


def test_interpolate_features_exact_inputs():
    """Bilinear token sampling, zero outside the grid, atol 1e-6."""
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(8, 10, 16)).astype(np.float32)
    pts = rng.uniform(-5, 45, size=(60, 2)).astype(np.float32)
    want = np.asarray(jdino.interpolate_features(jnp.asarray(grid), jnp.asarray(pts), (32, 40), 4))
    got = tdino.interpolate_features(torch.from_numpy(grid), torch.from_numpy(pts), (32, 40)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_cast_for_inference_matches_extractor_cast():
    """bf16 storage of the same leaves the JAX extractor casts."""
    jcfg, tcfg = _cfgs("bfloat16", "hbm")
    ext = jdino.DinoFeatureExtractor(cfg=jcfg, stride=14)
    params = ext.init_random(hw=(56, 56))
    tm = load_vit(tdino.DinoViT(tcfg), jax.device_get(params)).cast_for_inference()
    assert tm.pos_embed.dtype == torch.bfloat16 == tm.blocks[0].attn.qkv.weight.dtype
    assert tm.patch_embed.weight.dtype == torch.bfloat16
    assert tm.blocks[0].ls1.dtype == torch.float32 == tm.norm.weight.dtype
    assert str(jnp.asarray(params["params"]["pos_embed"]).dtype) == "bfloat16"
    img = _img((56, 56))
    want = np.asarray(ext.model.apply(params, jnp.asarray(img)))
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=0.1)


@pytest.mark.parametrize("attn_impl", ["kernel", "hbm"])
def test_batched_forward_equals_single_images_and_jax_vmap(attn_impl):
    """(B, H, W, 3) through one forward against B single-image forwards,
    atol 1e-5 (f32), and against jax.vmap of the JAX ViT: "kernel" (K1's
    plain version here) against the Pallas path atol 2e-3, "hbm" against the
    reference's default formulation atol 1e-4 (both f32, no bf16 rounding)."""
    jm, params, tm = _models("float32", "pallas" if attn_impl == "kernel" else "hbm")
    tm = load_vit(tdino.DinoViT(tdino.ViTConfig(**{**tm.cfg.__dict__, "attn_impl": attn_impl})),
                  jax.device_get(params))
    imgs = np.stack([_img(seed=s) for s in range(3)])
    want = np.asarray(jax.vmap(lambda im: jm.apply(params, im))(jnp.asarray(imgs)))
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs)).numpy()
        singles = np.stack([tm(torch.from_numpy(im)).numpy() for im in imgs])
    assert got.shape == want.shape == (3, 5, 6, 64)
    np.testing.assert_allclose(got, singles, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-3 if attn_impl == "kernel" else 1e-4)


def test_hbm_attention_is_differentiable_and_kernel_is_not():
    """Gradients reach the patch embedding through "hbm"; through "kernel"
    the forward raises instead of cutting the graph."""
    _, params, _ = _models("float32", "hbm")
    cfg = tdino.ViTConfig(embed_dim=64, depth=2, num_heads=4, layerscale_init=1.0,
                          compute_dtype="float32", attn_impl="hbm")
    tm = load_vit(tdino.DinoViT(cfg), jax.device_get(params))
    tm(torch.from_numpy(_img((56, 56)))).square().sum().backward()
    assert float(tm.patch_embed.weight.grad.abs().max()) > 0
    assert float(tm.blocks[0].attn.qkv.weight.grad.abs().max()) > 0
    with pytest.raises(ValueError):
        tdino.DinoViT(tdino.ViTConfig(embed_dim=64, depth=1, num_heads=1, attn_impl="flash"))
    assert (tdino.VIT_S14.embed_dim, tdino.VIT_S14.depth, tdino.VIT_S14.num_heads) == \
        (jdino.VIT_S14.embed_dim, jdino.VIT_S14.depth, jdino.VIT_S14.num_heads)
    assert (tdino.VIT_B14.embed_dim, tdino.VIT_B14.depth, tdino.VIT_B14.num_heads) == \
        (jdino.VIT_B14.embed_dim, jdino.VIT_B14.depth, jdino.VIT_B14.num_heads)


def test_bbox_crop_token_grid_takes_a_stack_of_masks():
    """One call on (B, H, W) masks of a frame against B calls, atol 1e-5, and
    against jax.vmap over the masks (`cppf2_tpu/eval/driver.py:380-385`),
    atol 2e-3; the transforms exactly."""
    jm, params, tm = _models("float32", "pallas")
    rgb, mask, _ = _frame()
    masks = np.stack([mask, np.roll(mask, (7, -20), (0, 1)), mask & (np.mgrid[0:60, 0:80][1] < 50)])
    grids_j, txys_j = jax.vmap(lambda m: jdino.bbox_crop_token_grid(
        jm, params, jnp.asarray(rgb), m, out_size=32, stride=8))(jnp.asarray(masks))
    with torch.no_grad():
        grids, txys = tdino.bbox_crop_token_grid(tm, torch.from_numpy(rgb), torch.from_numpy(masks),
                                                 out_size=32, stride=8)
        for i in range(3):
            g1, t1 = tdino.bbox_crop_token_grid(tm, torch.from_numpy(rgb), torch.from_numpy(masks[i]),
                                                out_size=32, stride=8)
            np.testing.assert_allclose(grids[i].numpy(), g1.numpy(), atol=1e-5)
            assert torch.equal(txys[i], t1)
    assert grids.shape == (3, 4, 4, 64) and txys.shape == (3, 3)
    np.testing.assert_array_equal(txys.numpy(), np.asarray(txys_j))
    np.testing.assert_allclose(grids.numpy(), np.asarray(grids_j), atol=2e-3)
