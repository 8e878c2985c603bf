"""Plain versions of the port's two kernels against the JAX package.

K2 (`cppf2_torch.ops.hist16`, both entries) against the Pallas histogram in
interpret mode and against the XLA twin `_hist16_matmul`; K1
(`cppf2_torch.ops.attention`) against the Pallas attention in interpret mode.
On the CPU the port's wrappers take their plain versions, which is what runs
here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cppf2_torch.ops import attention, hist16
from cppf2_tpu.ops.pallas_attention import mha_pallas
from cppf2_tpu.ops.pallas_kernels import hist16_pallas
from cppf2_tpu.ops.voting import _hist16_matmul


def _votes(rng, v, tie=False):
    lo = np.array([-0.1, 0.05, 0.6], np.float32)
    cell = np.array([0.011, 0.007, 0.013], np.float32)
    # clustered votes, some outside the 16^3 window, some masked
    cand = (lo + cell * rng.normal(8.0, 5.0, size=(v, 3))).astype(np.float32)
    ok = rng.uniform(size=v) < 0.9
    if tie:
        # top two cells up to the same, largest count: the lower flat index
        # (2, 12, 7) must win over (9, 3, 4). The count stays below 256: the
        # XLA twin's bf16 one-hot product rounds its output to bf16 on the
        # CPU, so it is exact only below 2^8 there.
        ids = np.floor((cand - lo) / cell + np.float32(0.5))
        extra = []
        for cell_id in ([9, 3, 4], [2, 12, 7]):
            have = int(np.sum(ok & np.all(ids == cell_id, axis=-1)))
            pt = (lo + cell * np.array(cell_id, np.float32)).astype(np.float32)
            extra.append(np.repeat(pt[None], 200 - have, axis=0))
        extra = np.concatenate(extra)
        cand = np.concatenate([cand, extra]).astype(np.float32)
        ok = np.concatenate([ok, np.ones(len(extra), bool)])
    return cand, ok, lo, cell


def _pallas_ids(cand, ok, lo, cell):
    ids = jnp.floor((jnp.asarray(cand) - lo) / cell + 0.5).astype(jnp.int32)
    inside = jnp.all((ids >= 0) & (ids < 16), -1) & jnp.asarray(ok)
    return jnp.clip(ids, 0, 15), inside


@pytest.mark.parametrize("tie", [False, True])
def test_hist16_counts_match_pallas(tie):
    """Exact integer counts (tolerance 0) against hist16_pallas(interpret)."""
    cand, ok, lo, cell = _votes(np.random.default_rng(1), 6000, tie)
    ids, inside = _pallas_ids(cand, ok, lo, cell)
    want = np.asarray(hist16_pallas(ids, inside, interpret=True)).reshape(-1)
    got = hist16.hist16_counts_plain(
        torch.from_numpy(cand), torch.from_numpy(ok), torch.from_numpy(lo),
        torch.from_numpy(cell)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("tie", [False, True])
def test_hist16_peak_matches_xla_twin(tie):
    """Center and count exact against _hist16_matmul, ties included."""
    cand, ok, lo, cell = _votes(np.random.default_rng(2), 20000, tie)
    want_c, want_n = _hist16_matmul(jnp.asarray(cand), jnp.asarray(ok), jnp.asarray(lo),
                                    jnp.asarray(cell))
    got_c, got_n = hist16.hist16_peak(torch.from_numpy(cand), torch.from_numpy(ok),
                                      torch.from_numpy(lo), torch.from_numpy(cell))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert float(got_n) == float(want_n)
    if tie:
        assert float(got_n) == 200
        np.testing.assert_array_equal(got_c.numpy(), lo + cell * np.array([2, 12, 7], np.float32))


def test_hist16_wrapper_checks_inputs():
    cand = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        hist16.hist16_peak(cand.double(), torch.ones(4, dtype=torch.bool), torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError):
        hist16.hist16_peak(cand, torch.ones(5, dtype=torch.bool), torch.zeros(3), torch.ones(3))


def _level_inputs(rng, sub, arc):
    """Per-pair quantities of one vote level, as `vote_center` makes them:
    circle centers c around a 16-cell window, an orthonormal (x0, y0) per
    pair, radii odist, a mask, and for an arc level theta_star and span."""
    lo = np.array([-0.1, 0.05, 0.6], np.float32)
    cell = np.array([0.011, 0.007, 0.013], np.float32)
    c = (lo + cell * rng.uniform(2.0, 14.0, size=(sub, 3))).astype(np.float32)
    x0 = rng.normal(size=(sub, 3))
    x0 /= np.linalg.norm(x0, axis=-1, keepdims=True)
    y0 = rng.normal(size=(sub, 3))
    y0 -= np.sum(y0 * x0, -1, keepdims=True) * x0
    y0 /= np.linalg.norm(y0, axis=-1, keepdims=True)
    odist = rng.uniform(0.005, 0.08, sub).astype(np.float32)
    ok = rng.uniform(size=sub) < 0.9
    out = dict(c=c, x0=x0.astype(np.float32), y0=y0.astype(np.float32), odist=odist, ok=ok,
               lo=lo, cell=cell)
    if arc:
        out["theta_star"] = rng.uniform(-np.pi, np.pi, sub).astype(np.float32)
        out["span"] = np.clip(1.2 * 0.09 / odist, 0.0, np.pi).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


@pytest.mark.parametrize("level,sub,n_smp", [("circle", 300, 16), ("coarse_arc", 300, 16),
                                             ("fine_arc", 700, 8)])
def test_hist16_level_peak_matches_candidates_written_out(level, sub, n_smp):
    """The fused level's plain version equals hist16_peak_plain on candidates
    built the way vote_center built them before the fusion, exactly; the same
    candidates through hist16_pallas(interpret) and _hist16_matmul give the
    same peak and count (counts stay below 256 a cell, where the XLA twin's
    bf16 one-hot product is exact on the CPU)."""
    x = _level_inputs(np.random.default_rng(11), sub, level != "circle")
    c, x0, y0, od, ok, lo, cell = (x[k] for k in ("c", "x0", "y0", "odist", "ok", "lo", "cell"))
    if level == "circle":
        ang = torch.arange(n_smp, dtype=torch.float32) / n_smp * 2 * torch.pi
        cosv, sinv = torch.cos(ang), torch.sin(ang)
        samples, extra = torch.stack([cosv, sinv]), ()
        offs = (cosv[None, :, None] * x0[:, None, :]
                + sinv[None, :, None] * y0[:, None, :]) * od[:, None, None]
    else:
        from cppf2_torch.ops.voting import _linspace
        samples, extra = _linspace(n_smp, "cpu"), (x["theta_star"], x["span"])
        theta = x["theta_star"][:, None] + samples[None, :] * x["span"][:, None]
        offs = (torch.cos(theta)[..., None] * x0[:, None, :]
                + torch.sin(theta)[..., None] * y0[:, None, :]) * od[:, None, None]
    cand = (c[:, None, :] + offs).reshape(-1, 3)
    ok_v = ok[:, None].expand(sub, n_smp).reshape(-1)

    want_c, want_n = hist16.hist16_peak_plain(cand, ok_v, lo, cell)
    for fn in (hist16.hist16_level_peak, hist16.hist16_level_peak_plain):
        got_c, got_n = fn(c, x0, y0, od, ok, samples, lo, cell, *extra)
        torch.testing.assert_close(got_c, want_c, atol=0, rtol=0)
        assert float(got_n) == float(want_n)
    assert 0 < float(want_n) < 256

    ids, inside = _pallas_ids(cand.numpy(), ok_v.numpy(), lo.numpy(), cell.numpy())
    counts = np.asarray(hist16_pallas(ids, inside, interpret=True)).reshape(-1)
    best = int(np.argmax(counts))   # the first maximum
    peak = lo.numpy() + np.array([best // 256, (best // 16) % 16, best % 16], np.float32) * cell.numpy()
    np.testing.assert_array_equal(want_c.numpy(), peak)
    assert float(want_n) == float(counts[best])
    jax_c, jax_n = _hist16_matmul(jnp.asarray(cand.numpy()), jnp.asarray(ok_v.numpy()),
                                  jnp.asarray(lo.numpy()), jnp.asarray(cell.numpy()))
    np.testing.assert_array_equal(want_c.numpy(), np.asarray(jax_c))
    assert float(want_n) == float(jax_n)


def test_hist16_level_wrapper_checks_inputs():
    x = _level_inputs(np.random.default_rng(12), 8, True)
    ts = torch.linspace(-1, 1, 4)
    args = lambda **kw: [({**x, "samples": ts} | kw)[k] for k in
                         ("c", "x0", "y0", "odist", "ok", "samples", "lo", "cell", "theta_star", "span")]
    hist16.hist16_level_peak(*args())                                   # well-formed
    hist16.hist16_level_peak(*args(samples=torch.ones(2, 4), theta_star=None, span=None))
    for bad in (dict(c=x["c"].double()),                                # a wrong type
                dict(ok=x["ok"].float()),
                dict(x0=x["x0"][:5]),                                   # a wrong shape
                dict(span=x["span"][:5]),
                dict(samples=torch.ones(2, 4)),                         # a cos/sin table with arcs
                dict(samples=ts, theta_star=None, span=None),           # arc positions without arcs
                dict(span=None),                                        # half of the arc pair
                dict(lo=torch.zeros(3, device="meta"))):                # several devices
        with pytest.raises(ValueError):
            hist16.hist16_level_peak(*args(**bad))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [1, 64, 65])
def test_mha_plain_matches_pallas_at_tile_edges(t, out_dtype):
    """h 2, hd 64, T = t_real at the edges of one 64-row tile, with the
    tolerances of test_mha_plain_matches_pallas."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, t, 64)).astype(np.float32) for _ in range(3))
    q = q / 8.0
    jdt = jnp.bfloat16 if out_dtype == "bfloat16" else jnp.float32
    want = mha_pallas(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                      jnp.asarray(v, jnp.bfloat16), block_q=64, interpret=True, t_real=t,
                      out_dtype=jdt)
    tdt = getattr(torch, out_dtype)
    got = attention.mha(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                        torch.from_numpy(v).bfloat16(), t_real=t, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (2, t, 64)
    atol = 1.6e-2 if out_dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=atol)


def test_mha_takes_strided_views():
    """(h, T, 64) views of a (T, 3 * h * 64) projection give exactly what
    their contiguous copies give, and are what the CUDA path reads in place."""
    rng = np.random.default_rng(6)
    t, h = 70, 4
    qkv = torch.from_numpy(rng.normal(size=(t, 3 * h * 64)).astype(np.float32)).bfloat16()
    views = [x.reshape(t, h, 64).transpose(0, 1) for x in torch.split(qkv, h * 64, dim=-1)]
    assert all(attention._tma_readable(x) and not x.is_contiguous() for x in views)
    assert not attention._tma_readable(qkv.reshape(t, 3 * h, 64).transpose(0, 1)[:, :, 1:9])
    # an expanded view (stride 0) is no tensor map either: it is copied
    assert not attention._tma_readable(views[0][:1].expand(h, t, 64))
    got = attention.mha(*views, t_real=66, out_dtype=torch.float32)
    want = attention.mha(*(x.contiguous() for x in views), t_real=66, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_mha_plain_matches_pallas(out_dtype):
    """h 2, T 130, t_real 100, hd 64. Both take f32 logits of bf16 inputs and
    round P to bf16; the sums run in another order, so a bf16 output is held
    to 2 bf16 ulps (atol 1.6e-2 at |o| < 1) and an f32 output to 2e-3."""
    rng = np.random.default_rng(3)
    h, t, hd, t_real = 2, 130, 64, 100
    q, k, v = (rng.normal(size=(h, t, hd)).astype(np.float32) for _ in range(3))
    q = q / np.sqrt(hd)
    jdt = jnp.bfloat16 if out_dtype == "bfloat16" else jnp.float32
    want = mha_pallas(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                      jnp.asarray(v, jnp.bfloat16), block_q=64, interpret=True,
                      t_real=t_real, out_dtype=jdt)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, out_dtype)
    got = attention.mha(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                        torch.from_numpy(v).bfloat16(), t_real=t_real, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (h, t, hd)
    atol = 1.6e-2 if out_dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(got.float().numpy()[:, :t_real], want[:, :t_real], atol=atol)
    # keys at or beyond t_real carry no weight: changing them changes nothing
    k2 = k.copy()
    k2[:, t_real:] = 50.0
    got2 = attention.mha(torch.from_numpy(q).bfloat16(), torch.from_numpy(k2).bfloat16(),
                         torch.from_numpy(v).bfloat16(), t_real=t_real, out_dtype=tdt)
    torch.testing.assert_close(got2, got, atol=0, rtol=0)


def test_mha_wrapper_checks_inputs():
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.mha(x.float(), x, x)
    with pytest.raises(ValueError):
        attention.mha(x, x, x, t_real=9)


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Both CUDA kernels against their plain versions at small shapes (the
    card run of `chip_smoke.py` checks the production shapes), and TF32 off
    once a CUDA entry point has resolved its device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from cppf2_torch import resolve_device

    dev = resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    cand, ok, lo, cell = (torch.from_numpy(a).to(dev) for a in _votes(np.random.default_rng(4), 50000, True))
    c_k, n_k = hist16.hist16_peak(cand, ok, lo, cell)
    c_p, n_p = hist16.hist16_peak_plain(cand, ok, lo, cell)
    torch.testing.assert_close(c_k, c_p, atol=0, rtol=0)
    assert float(n_k) == float(n_p)
    for arc in (False, True):
        x = {k: v.to(dev) for k, v in _level_inputs(np.random.default_rng(13), 5000, arc).items()}
        samples = (torch.linspace(-1, 1, 8) if arc else torch.ones(2, 16) * 0.6).to(dev)
        args = [x[k] for k in ("c", "x0", "y0", "odist", "ok")] + [samples, x["lo"], x["cell"]]
        args += [x["theta_star"], x["span"]] if arc else []
        c_k, n_k = hist16.hist16_level_peak(*args)
        c_p, n_p = hist16.hist16_level_peak_plain(*args)
        torch.testing.assert_close(c_k, c_p, atol=0, rtol=0)
        assert float(n_k) == float(n_p)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((4, 200, 64), generator=g, device=dev).bfloat16() for _ in range(3))
    torch.testing.assert_close(attention.mha(q, k, v, t_real=150).float(),
                               attention.mha_plain(q, k, v, t_real=150).float(), atol=2e-2, rtol=0)
