"""Plain versions of the port's two kernels against the JAX package.

K2 (`cppf2_torch.ops.hist16`) against the Pallas histogram in interpret mode
and against the XLA twin `_hist16_matmul`; K1 (`cppf2_torch.ops.attention`)
against the Pallas attention in interpret mode. On the CPU the port's
wrappers take their plain versions, which is what runs here.
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
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((4, 200, 64), generator=g, device=dev).bfloat16() for _ in range(3))
    torch.testing.assert_close(attention.mha(q, k, v, t_real=150).float(),
                               attention.mha_plain(q, k, v, t_real=150).float(), atol=2e-2, rtol=0)
