"""The int8 (W8A8) ViT, the chunked attention and the fixed-window visual
frontend of the port against the JAX package: `QDense` against `_QDense`,
`quantize_vit_params`, the int8 ViT and extractor, `attn_impl="chunked"`
and `masked_window_descriptors`. JAX runs its "hbm" or chunked attention on
the CPU, as `tests/test_dinov2.py` does; the port's "kernel" route is K1's
plain version here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models.layers import Dense, QDense, quantize_kernel
from cppf2_torch.models.porting import load_vit, vit_to_tree
from cppf2_tpu.models import dinov2 as jdino

BF16_ULP = 2.0 ** -7   # one bf16 ulp relative to the value


def _img(hw=(56, 56), seed=0):
    return np.random.default_rng(seed).uniform(size=(*hw, 3)).astype(np.float32)


def _jax_params(cfg, hw=(56, 56), seed=0):
    model = jdino.DinoViT(cfg)
    return model, jax.device_get(model.init(jax.random.key(seed), jnp.zeros((*hw, 3))))


def _jax_qdense(d_in, d_out, compute_dtype, seed=0):
    """A JAX _QDense with int8 codes of a lecun-normal kernel, a nonzero
    bias (so the fused multiply-add of the epilogue shows) and its scales."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    codes, s = quantize_kernel(w)
    bias = rng.normal(size=d_out).astype(np.float32)
    cfg = jdino.ViTConfig(quant="int8", compute_dtype=compute_dtype)
    params = {"params": {"kernel": jnp.asarray(codes), "qscale": jnp.asarray(s),
                         "bias": jnp.asarray(bias)}}
    return jdino._QDense(d_out, cfg), params, codes, s, bias


def test_quantize_vit_params_bit_for_bit():
    """The codes and scales of every quantized kernel equal the JAX
    function's exactly; the other leaves are untouched, and the module's
    own `quantize_` gives the same tree (`vit_to_tree`)."""
    cfg = jdino.ViTConfig(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, quant="int8")
    _, params = _jax_params(cfg)
    want = jdino.quantize_vit_params(params, cfg)
    got = tdino.quantize_vit_params(params)
    wb, gb = want["params"]["blocks"], got["params"]["blocks"]
    for path in (("attn", "qkv"), ("attn", "proj"), ("mlp_fc1",), ("mlp_fc2",)):
        w, g = wb, gb
        for k in path:
            w, g = w[k], g[k]
        assert g["kernel"].dtype == np.int8 and g["kernel"].shape == (2, *np.shape(w["kernel"])[1:])
        np.testing.assert_array_equal(g["kernel"], np.asarray(w["kernel"]))
        assert g["qscale"].dtype == np.float32
        np.testing.assert_array_equal(g["qscale"], np.asarray(w["qscale"]))
        np.testing.assert_array_equal(g["bias"], np.asarray(w["bias"]))
    np.testing.assert_array_equal(gb["norm1"]["scale"], np.asarray(wb["norm1"]["scale"]))
    assert params["params"]["blocks"]["mlp_fc1"]["kernel"].dtype == np.float32  # a copy
    tcfg = tdino.ViTConfig(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, quant="int8")
    module = load_vit(tdino.DinoViT(tcfg), params).quantize_()
    tree = vit_to_tree(module)["params"]["blocks"]
    np.testing.assert_array_equal(tree["mlp_fc2"]["kernel"], gb["mlp_fc2"]["kernel"])
    np.testing.assert_array_equal(tree["attn"]["qkv"]["qscale"], gb["attn"]["qkv"]["qscale"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out,in_bf16", [(64, 48, False), (1024, 3072, False),
                                                (1024, 1024, True)])
def test_qdense_matches_jax(compute_dtype, d_in, d_out, in_bf16):
    """One int8 layer on the same input: the activation codes and the int32
    products equal JAX's exactly; the outputs equal exactly in float32 (the
    port takes XLA's product with the float32 reciprocal of 127 and its
    fused multiply-add) and within one bf16 ulp in bfloat16. A bf16 input
    (the proj and mlp_fc2 layers of a bf16 ViT) takes its max in bf16."""
    jm, params, codes, s, bias = _jax_qdense(d_in, d_out, compute_dtype)
    x = (np.random.default_rng(1).normal(size=(37, d_in)) * 3).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16) if in_bf16 else jnp.asarray(x)
    want = np.asarray(jax.jit(jm.apply)(params, xj).astype(jnp.float32))

    @jax.jit
    def jax_codes(x):
        ax = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True).astype(jnp.float32) / 127.0,
                         1e-12)
        xq = jnp.clip(jnp.round(x.astype(jnp.float32) / ax), -127, 127).astype(jnp.int8)
        return xq, jax.lax.dot_general(xq, jnp.asarray(codes), (((1,), (0,)), ((), ())),
                                       preferred_element_type=jnp.int32)

    xq_j, y_j = jax.device_get(jax_codes(xj))
    dt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    lin = QDense(d_in, d_out, dt)
    lin.set_int8(codes.T, s)
    with torch.no_grad():
        lin.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(torch.bfloat16 if in_bf16 else torch.float32)
    ax = torch.clamp(xt.abs().amax(-1, keepdim=True).float() * float(np.float32(1 / 127)), min=1e-12)
    xq = torch.clamp(torch.round(xt.float() / ax), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    np.testing.assert_array_equal(torch._int_mm(xq, lin.weight.t()).numpy(), y_j)
    before = QDense.launches
    with torch.no_grad():
        got = lin(xt)
    assert QDense.launches == before + 1 and got.dtype == dt and got.shape == (37, d_out)
    got = got.float().numpy()
    if compute_dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_less(np.abs(got - want), BF16_ULP * np.abs(want) + 1e-30)


def test_float_qdense_is_dense():
    """A QDense whose weight is not int8 is exactly `Dense`, as the JAX
    layer's float kernel takes the plain matmul; its `qscale` is ignored and
    the counter does not move."""
    torch.manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        q, d = QDense(64, 32, dt), Dense(64, 32, dt)
        d.load_state_dict({k: v for k, v in q.state_dict().items() if k != "qscale"})
        with torch.no_grad():
            q.qscale.fill_(3.0)
        x = torch.randn(5, 64)
        before = QDense.launches
        with torch.no_grad():
            assert torch.equal(q(x), d(x))
        assert QDense.launches == before


def _int8_vits(compute_dtype, attn_impl, embed_dim=1024, depth=2, heads=16):
    kw = dict(embed_dim=embed_dim, depth=depth, num_heads=heads, pretrain_grid=4,
              layerscale_init=1.0, compute_dtype=compute_dtype)
    jcfg = jdino.ViTConfig(**kw, quant="int8", attn_impl="hbm")
    jm, params = _jax_params(jcfg)
    qp = jdino.quantize_vit_params(params, jcfg)
    tm = load_vit(tdino.DinoViT(tdino.ViTConfig(**kw, quant="int8", attn_impl=attn_impl)),
                  tdino.quantize_vit_params(params))
    return jm, qp, tm, params, kw


@pytest.mark.parametrize("compute_dtype,attn_impl,max_diff", [
    ("float32", "hbm", 1e-4),
    ("bfloat16", "hbm", 0.1),
    ("bfloat16", "kernel", 0.1),
])
def test_int8_vit_matches_jax(compute_dtype, attn_impl, max_diff):
    """An int8 ViT (embed 1024, depth 2, 16 heads, layer scale 1) from the
    same quantized tree: every token's cosine against JAX's at least 0.9999.
    In float32 only summation orders differ (max |diff| measured 1.4e-6,
    held at 1e-4); in bfloat16 the packages round elementwise steps
    differently and a flipped bf16 value can flip an activation code (max
    |diff| measured 0.046 on unit-variance tokens, held at 0.1). 8 int8
    layers run."""
    jm, qp, tm, _, _ = _int8_vits(compute_dtype, attn_impl)
    img = _img()
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, qp), jnp.asarray(img)))
    before = QDense.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
    assert QDense.launches == before + 8
    assert got.shape == want.shape == (4, 4, 1024)
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999, cos.min()
    assert np.abs(got - want).max() <= max_diff


def test_int8_tree_round_trip():
    """load_vit / vit_to_tree carry a JAX int8 tree both ways (int8 kernels
    (depth, d_in, d_out), qscale (depth, d_out)); a quant="int8" model that
    is not quantized yet carries qscale of ones, as the JAX init does; an
    int8 tree into a model without quant raises."""
    cfg = jdino.ViTConfig(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, quant="int8")
    _, params = _jax_params(cfg)
    qp = jdino.quantize_vit_params(params, cfg)
    tcfg = tdino.ViTConfig(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, quant="int8")
    back = vit_to_tree(load_vit(tdino.DinoViT(tcfg), qp))["params"]["blocks"]
    for name in ("mlp_fc1", "mlp_fc2"):
        assert back[name]["kernel"].dtype == np.int8
        np.testing.assert_array_equal(back[name]["kernel"], qp["params"]["blocks"][name]["kernel"])
        np.testing.assert_array_equal(back[name]["qscale"], qp["params"]["blocks"][name]["qscale"])
        np.testing.assert_array_equal(back[name]["bias"], qp["params"]["blocks"][name]["bias"])
    fresh = vit_to_tree(load_vit(tdino.DinoViT(tcfg), params))["params"]["blocks"]["attn"]["qkv"]
    assert fresh["kernel"].dtype == np.float32
    np.testing.assert_array_equal(fresh["qscale"], np.asarray(params["params"]["blocks"]["attn"]["qkv"]["qscale"]))
    assert np.all(fresh["qscale"] == 1.0)
    with pytest.raises(ValueError, match="quant"):
        load_vit(tdino.DinoViT(dataclasses.replace(tcfg, quant="none")), qp)
    with pytest.raises(ValueError, match="quant"):
        tdino.DinoViT(dataclasses.replace(tcfg, quant="int4"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layerscale", [1e-5, 1.0])
def test_int8_extractor_matches_jax(seed, layerscale):
    """DinoFeatureExtractor(cfg=ViTConfig(quant="int8")) on the same float
    tree as JAX's: both quantize it once at load; stride 4 on a 32 x 32
    crop, float32 linears and "hbm" attention. JAX resizes the crop with
    `jax.image.resize`, the port with two products (92% of the pixels differ
    by up to 2.7e-6), and such a last-bit difference can move an activation
    across a rounding boundary of its int8 code. At the default layer scale
    1e-5 the unit descriptors agree within 1e-5 (measured 1.2e-6); at 1.0,
    where every block moves the tokens, every cosine is at least 0.9995
    (measured 0.99992) and max |diff| at most 1e-2 (measured 5.0e-3).
    Giving the int8 tree itself loads it as it is, and the `quant=` keyword
    sets the config: the same descriptors."""
    kw = dict(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, layerscale_init=layerscale,
              compute_dtype="float32")
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    kp = rng.uniform(-1, 33, size=(60, 2)).astype(np.float32)
    jext = jdino.DinoFeatureExtractor(cfg=jdino.ViTConfig(**kw, quant="int8"), stride=4, out_size=32)
    _, params = _jax_params(jdino.ViTConfig(**kw, quant="int8"), hw=(112, 112), seed=seed)
    jext.params = jext._cast(params)
    want = np.asarray(jext(jnp.asarray(img), jnp.asarray(kp)))
    tcfg = tdino.ViTConfig(**kw, quant="int8", attn_impl="hbm")
    outs = []
    for tree, extra in ((params, {}), (jdino.quantize_vit_params(params), {}),
                        (params, {"cfg": dataclasses.replace(tcfg, quant="none"), "quant": "int8"})):
        text = tdino.DinoFeatureExtractor(params=tree, **{"cfg": tcfg, **extra}, stride=4,
                                          out_size=32, device="cpu")
        assert text.cfg.quant == "int8"
        assert text.model.blocks[1].mlp_fc1.weight.dtype == torch.int8
        outs.append(text(torch.from_numpy(img), torch.from_numpy(kp)).numpy())
    got = outs[0]
    for other in outs[1:]:
        np.testing.assert_array_equal(other, got)
    if layerscale < 1.0:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        inside = np.linalg.norm(want, axis=-1) > 0
        assert np.array_equal(inside, np.linalg.norm(got, axis=-1) > 0)
        assert np.sum(got * want, -1)[inside].min() >= 0.9995
        assert np.abs(got - want).max() <= 1e-2


def test_int8_against_float_on_the_port():
    """The port alone: the int8 ViT against the float32 ViT of the same
    weights (`tests/test_dinov2.py`'s check): every token's cosine above
    0.999, at the default layer scale 1e-5 and at 1.0."""
    for ls in (1e-5, 1.0):
        kw = dict(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, layerscale_init=ls,
                  compute_dtype="float32", attn_impl="hbm")
        _, params = _jax_params(jdino.ViTConfig(**{k: v for k, v in kw.items() if k != "attn_impl"}))
        ref = load_vit(tdino.DinoViT(tdino.ViTConfig(**kw)), params)
        q = load_vit(tdino.DinoViT(tdino.ViTConfig(**kw, quant="int8")), params)
        img = torch.from_numpy(_img(seed=3))
        with torch.no_grad():
            pre = q(img)
            q.quantize_()
            out, want = q(img), ref(img)
        assert torch.allclose(pre, want, atol=1e-5)   # not yet quantized: the float route
        cos = torch.nn.functional.cosine_similarity(out, want, dim=-1)
        assert float(cos.min()) > 0.999, float(cos.min())


def test_load_backbone_quantizes(tmp_path):
    """load_backbone(..., quant="int8") passes the option through and
    returns the ViT quantized; the file holds float32 leaves."""
    cfg = tdino.ViTConfig(embed_dim=64, depth=1, num_heads=4, pretrain_grid=4)
    vit = tdino.DinoViT(cfg).init_random(torch.Generator().manual_seed(0))
    prefix = str(tmp_path / "bb")
    tdino.save_backbone(prefix, vit, stride=4, out_size=32)
    model, lcfg, stride, out_size = tdino.load_backbone(prefix, device="cpu", quant="int8",
                                                        attn_impl="hbm")
    assert lcfg.quant == "int8" and (stride, out_size) == (4, 32)
    assert model.blocks[0].attn.qkv.weight.dtype == torch.int8
    img = torch.from_numpy(_img(seed=1))
    with torch.no_grad():
        cos = torch.nn.functional.cosine_similarity(model(img), vit(img), dim=-1)
    assert float(cos.min()) > 0.999


def test_chunked_attention_matches_jax():
    """attn_impl="chunked" with attn_chunk 7 on 17 tokens (a padded last
    block of 4 keys) in float32 against JAX's chunked route, atol 1e-5; the
    same against the port's "hbm" route."""
    kw = dict(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, layerscale_init=1.0,
              compute_dtype="float32")
    jm, params = _jax_params(jdino.ViTConfig(**kw, attn_impl="chunked", attn_chunk=7))
    img = _img()
    want = np.asarray(jm.apply(params, jnp.asarray(img)))
    tm = load_vit(tdino.DinoViT(tdino.ViTConfig(**kw, attn_impl="chunked", attn_chunk=7)), params)
    hbm = load_vit(tdino.DinoViT(tdino.ViTConfig(**kw, attn_impl="hbm")), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
        ref = hbm(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    imgs = torch.from_numpy(np.stack([img, _img(seed=4)]))
    with torch.no_grad():
        batched = tm(imgs)
    np.testing.assert_allclose(batched[0].numpy(), got, atol=1e-5)


def test_chunked_attention_gradient_matches_hbm():
    """The chunked route is differentiable: the gradient of a loss with
    respect to every parameter equals the "hbm" route's within 1e-5 of the
    leaf's largest entry (float32)."""
    kw = dict(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, layerscale_init=1.0,
              compute_dtype="float32")
    _, params = _jax_params(jdino.ViTConfig(**kw))
    img = torch.from_numpy(_img())
    # a fixed random readout: the sum of squares of layer-normed tokens does
    # not depend on the tokens, and its gradients would be rounding noise
    readout = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 4, 64)).astype(np.float32))
    grads = []
    for impl in ("chunked", "hbm"):
        m = load_vit(tdino.DinoViT(tdino.ViTConfig(**kw, attn_impl=impl, attn_chunk=7)), params)
        (m(img) * readout).sum().backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    for name, g in grads[0].items():
        ref = grads[1][name]
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((g - ref).abs().max()) <= 1e-5 * scale, name


def _window_frame(h=60, w=80, seed=5):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(h, w, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    mask = ((xs - 60) ** 2 / 300 + (ys - 40) ** 2 / 150) < 1
    yy, xx = np.nonzero(mask)
    pix = np.stack([yy, xx], -1)[rng.choice(len(yy), 40)].astype(np.int32)
    return rgb, mask, pix


@pytest.mark.parametrize("window", [(10, 20), (40, 60), (-3, 50)])
def test_masked_window_descriptors_matches_jax(window):
    """A 32 x 32 window at stride 4 (112 x 112 into the ViT), f32 linears,
    against JAX at 2e-3: inside the frame, and at and past its edge, where
    `dynamic_slice` moves the window back into the frame while the keypoints
    stay relative to the window as given."""
    kw = dict(embed_dim=64, depth=2, num_heads=4, pretrain_grid=4, layerscale_init=1.0,
              compute_dtype="float32")
    jm, params = _jax_params(jdino.ViTConfig(**kw), hw=(112, 112))
    rgb, mask, pix = _window_frame()
    wyx = np.asarray(window, np.int32)
    want = np.asarray(jdino.masked_window_descriptors(
        jm, params, jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(pix), jnp.asarray(wyx),
        crop=32, stride=4))
    for impl in ("hbm", "kernel"):
        tm = load_vit(tdino.DinoViT(tdino.ViTConfig(**kw, attn_impl=impl)), params)
        with torch.no_grad():
            got = tdino.masked_window_descriptors(
                tm, torch.from_numpy(rgb), torch.from_numpy(mask), torch.from_numpy(pix),
                torch.from_numpy(wyx), crop=32, stride=4).numpy()
        assert got.shape == want.shape == (40, 64)
        np.testing.assert_allclose(got, want, atol=2e-3)
