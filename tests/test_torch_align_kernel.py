"""The alignment's kernel (`csrc/align.cu`) and its hand-written gradient.

On the CPU: `_align_grads_plain`, the kernel's 12 sums and chain rule in
plain PyTorch, against autograd's gradient of the plain loop's loss, the
wrapper's input checks, and the gaps and losses the checks read. On a CUDA
card (marked `gpu`, skipped elsewhere): the kernel's plan, the kernel
against the plain loop on the same card, and the one launch that a replay of
a pose program credits.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from cppf2_torch.core.geometry import quat_to_matrix
from cppf2_torch.infer import alignment
from cppf2_torch.ops import _build


def _plain_loss(pair_pts, pred, w, r0, trans, quat, up_sym, up_axis):
    """The plain loop's summed row losses at (trans, quat), as it writes them."""
    w = (w > 0).to(pair_pts.dtype)
    w_pairs = w[..., None, None]
    denom = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    rot = quat_to_matrix(quat) @ r0
    canon = torch.bmm(pair_pts.reshape(pair_pts.shape[0], -1, 3) - trans[:, None, :],
                      rot).reshape(pair_pts.shape)
    diff = torch.abs(canon - pred)
    if up_sym:
        return torch.sum(torch.sum(diff[..., up_axis] * w_pairs[..., 0], dim=(1, 2)) / (denom * 2.0))
    return torch.sum(torch.sum(diff * w_pairs, dim=(1, 2, 3)) / (denom * 6.0))


@pytest.mark.parametrize("up_sym,up_axis", [(False, 1), (True, 1), (True, 2)])
def test_hand_gradient_matches_autograd(up_sym, up_axis):
    """The kernel's 12 sums and chain rule, in plain PyTorch, against
    autograd's gradient of the plain loop's loss at random parameters (an
    unnormalised quaternion, so the normalisation's chain rule counts), to
    1e-5 of the largest entry; a row with every weight 0 has no gradient."""
    rng = np.random.default_rng(7)
    pts, pair_idx, w, pred, r0, t0 = alignment._synthetic_rows(rng, 3, 400)
    w[2] = 0.0
    pair_pts = alignment.take_rows(pts, pair_idx)
    trans = (t0 + torch.from_numpy(rng.normal(0, 0.01, size=(3, 3))).float()).requires_grad_(True)
    quat = torch.from_numpy(rng.normal(0, 0.1, size=(3, 4)) + [0, 0, 0, 1.3]).float()
    quat.requires_grad_(True)
    want_t, want_q = torch.autograd.grad(
        _plain_loss(pair_pts, pred, w, r0, trans, quat, up_sym, up_axis), [trans, quat])
    got_t, got_q = alignment._align_grads_plain(pair_pts, pred, w, r0, trans.detach(),
                                                quat.detach(), up_sym, up_axis)
    for got, want in ((got_t, want_t), (got_q, want_q)):
        scale = float(torch.max(torch.abs(want[:2])))
        assert scale > 0
        torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    assert float(torch.max(torch.abs(got_t[2]))) == 0 and float(torch.max(torch.abs(got_q[2]))) == 0


def test_check_helpers_read_known_gaps():
    """The gaps and float64 losses that the card test and `chip_smoke.py`
    read: a rotation 0.5 deg and a translation 2 mm away read as such, and
    the float64 loss at a pose is the plain loop's loss written out."""
    args = alignment._synthetic_rows(np.random.default_rng(4), 3, 300)
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(3, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    turn = torch.from_numpy(np.stack([_axis_angle(a, np.radians(0.5)) for a in axis]))
    shift = torch.from_numpy(axis * 2e-3)
    base = alignment.AlignResult(args[4].double(), args[5].double(), None)
    moved = alignment.AlignResult(turn @ base.rotation, base.translation + shift, None)
    deg, mm = alignment._pose_gaps(moved, base)
    torch.testing.assert_close(deg, torch.full((3,), 0.5, dtype=torch.float64), atol=1e-6, rtol=0)
    torch.testing.assert_close(mm, torch.full((3,), 2.0, dtype=torch.float64), atol=1e-9, rtol=0)
    quat = torch.tensor([[0.0, 0.0, 0.0, 1.0]] * 3, dtype=torch.float64)
    pair_pts = alignment.take_rows(args[0].double(), args[1])
    for up_sym, up_axis in ((False, 1), (True, 2)):
        want = torch.stack([_plain_loss(pair_pts[i:i + 1], args[3][i:i + 1].double(),
                                        args[2][i:i + 1], base.rotation[i:i + 1],
                                        base.translation[i:i + 1], quat[i:i + 1], up_sym, up_axis)
                            for i in range(3)])
        got = alignment._row_losses64(args, base, up_sym, up_axis)
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def _axis_angle(axis, angle):
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def test_kernel_inputs_checked():
    """The kernel's route takes float32 with int32 or int64 indices, and
    raises on anything else: there is no fallback to the plain loop."""
    pts, pair_idx, w, pred, r0, t0 = alignment._synthetic_rows(np.random.default_rng(1), 2, 50)
    alignment._check_kernel_inputs(pts, pair_idx, w, pred, r0, t0)
    alignment._check_kernel_inputs(pts, pair_idx.int(), w, pred, r0, t0)
    with pytest.raises(ValueError, match="points"):
        alignment._check_kernel_inputs(pts.double(), pair_idx, w, pred, r0, t0)
    with pytest.raises(ValueError, match="pair_idx"):
        alignment._check_kernel_inputs(pts, pair_idx.short(), w, pred, r0, t0)
    with pytest.raises(ValueError, match="pred_pairs_scaled"):
        alignment._check_kernel_inputs(pts, pair_idx, w, pred[:, :10], r0, t0)
    with pytest.raises(ValueError, match="unsupported device"):
        alignment.align_pose(pts.to("meta"), pair_idx.to("meta"), w.to("meta"), pred.to("meta"),
                             r0.to("meta"), t0.to("meta"), False)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the alignment kernel has no CPU mode")
    from cppf2_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
def test_cluster_plan():
    """Blocks a row from the shapes: 8 where the rows' clusters fit 132 SMs,
    fewer for more rows or few points, more where a slice would not fit in
    shared memory, and read from device memory past 8 blocks."""
    _card()
    assert alignment.cluster_plan(2, 5000, 132) == (8, 1250, True)
    assert alignment.cluster_plan(16, 5000, 132) == (8, 1250, True)
    assert alignment.cluster_plan(24, 5000, 132) == (4, 2500, True)
    assert alignment.cluster_plan(100, 5000, 132) == (2, 5000, True)
    assert alignment.cluster_plan(2, 37, 132) == (1, 74, True)
    assert alignment.cluster_plan(2, 0, 132) == (1, 0, True)
    assert alignment.cluster_plan(2, 40000, 132) == (8, 10000, False)


def _on_card(rng, b, k, dev, **kw):
    return [x.to(dev) for x in alignment._synthetic_rows(rng, b, k, **kw)]


@pytest.mark.gpu
@pytest.mark.parametrize("up_sym,up_axis", [(False, 1), (False, 2), (True, 1), (True, 2)])
@pytest.mark.parametrize("k", [5000, 4999, 37])
@pytest.mark.parametrize("b", [1, 2, 16, 24])
def test_kernel_matches_plain_loop_on_card(b, k, up_sym, up_axis):
    """The kernel against the plain loop, padded pairs, and with 2 rows or
    more a row with every weight 0 (its denominator clamped, its pose left
    where it started).

    Where nothing amplifies rounding, the poses are held to float32
    rounding of the plain loop run in float64 on the CPU (1e-3 deg and mm,
    loss 1e-4): after 1 step, and after 100 steps on predictions moved 10 m
    away, a loss without kinks on the path (1e-2 there: the pose travels
    about a metre in float32). The float64 loop, since Adam's first step
    divides a gradient by its own size: where a row's residual signs cancel,
    the kernel's sums of signs are exact and the float32 loop's are not, and
    its step then moves millimetres on rounding alone.

    On the realistic problem after 100 steps Adam's steps flip with the
    sign of single residuals near the L1 optimum, so last bits grow: the
    float32 plain loop on the card lands up to 0.23 mm (K >= 4,999) and 2.4
    mm (K = 37) from itself on the CPU, with the same float64 loss. There,
    against the float32 plain loop on the card: every row within the
    benchmark check's 0.3 deg and 1 mm at 4,999 pairs or more, and the
    mean float64 loss reached no more than 0.1% above the plain loop's (at
    37 pairs too); `test_kernel_lands_where_the_plain_loop_does` holds the
    typical row. Two calls give the same bits, and the kernel's final loss
    is the float64 loss at its pose to 1e-4. The launch table counts both."""
    dev = _card()
    seed = 1000 * b + k + 7 * up_sym + up_axis
    real = _on_card(np.random.default_rng(seed), b, k, dev)
    smooth = _on_card(np.random.default_rng(seed), b, k, dev, offset=10.0)
    for args in (real, smooth):
        if b > 1:
            args[2][1] = 0.0
    for args, steps in ((real, 1), (real, 100), (smooth, 100)):
        before = _build.launched("align")
        got = alignment.align_pose(*args, up_sym, up_axis, steps, 1e-2)
        again = alignment.align_pose(*args, up_sym, up_axis, steps, 1e-2)
        assert _build.launched("align") == before + 2
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        loss_k = alignment._row_losses64(args, got, up_sym, up_axis)
        torch.testing.assert_close(got.loss.double().cpu(), loss_k, atol=1e-9, rtol=1e-4)
        if b > 1:
            assert torch.equal(got.translation[1], args[5][1])
            torch.testing.assert_close(got.rotation[1], args[4][1], atol=1e-7, rtol=0)
        if args is real and steps == 100:
            want = alignment.align_pose_plain(*args, up_sym, up_axis, steps, 1e-2)
            loss_p = alignment._row_losses64(args, want, up_sym, up_axis)
            assert float(loss_k.mean()) <= 1.001 * float(loss_p.mean()), (loss_k, loss_p)
            if k > 37:
                deg, mm = alignment._pose_gaps(got, want)
                assert float(deg.max()) < 0.3 and float(mm.max()) < 1.0, (deg.tolist(), mm.tolist())
            continue
        want = alignment.align_pose_plain(*(x.cpu().double() if x.is_floating_point() else x.cpu()
                                            for x in args), up_sym, up_axis, steps, 1e-2)
        deg, mm = alignment._pose_gaps(got, want)
        tol = 1e-3 if steps == 1 else 1e-2
        assert float(deg.max()) < tol and float(mm.max()) < tol, (steps, deg.tolist(), mm.tolist())
        torch.testing.assert_close(got.loss.double().cpu(), want.loss, atol=1e-9, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("up_sym,up_axis", [(False, 1), (True, 1), (True, 2)])
@pytest.mark.parametrize("k", [5000, 4999])
def test_kernel_lands_where_the_plain_loop_does(k, up_sym, up_axis):
    """Realistic problems after 100 steps, at the main path's shapes (calls
    of 16 rows, the bucket-8 group program's), 48 rows: the kernel's poses
    against the float32 plain loop's on the card. The plain loop lands as
    far from itself on the CPU (median 0.015 deg / 0.03 mm a row without
    `up_sym`, at most 0.07 deg / 0.23 mm), so: the median gap a row under
    0.03 deg and 0.06 mm, every row under the benchmark check's 0.3 deg and
    1 mm, and the mean float64 loss reached within 0.02% of the plain
    loop's (48 rows of float noise part it by at most 0.002%)."""
    dev = _card()
    gaps, losses = [], []
    for call in range(3):
        rng = np.random.default_rng(100 * k + 10 * call + 3 * up_sym + up_axis)
        args = _on_card(rng, 16, k, dev)
        got = alignment.align_pose(*args, up_sym, up_axis, 100, 1e-2)
        want = alignment.align_pose_plain(*args, up_sym, up_axis, 100, 1e-2)
        gaps.append(torch.stack(alignment._pose_gaps(got, want), dim=-1))
        losses.append(torch.stack([alignment._row_losses64(args, r, up_sym, up_axis)
                                   for r in (got, want)], dim=-1))
    gaps, losses = torch.cat(gaps), torch.cat(losses)
    deg, mm = gaps.unbind(-1)
    assert float(deg.median()) < 0.03 and float(mm.median()) < 0.06, (deg.tolist(), mm.tolist())
    assert float(deg.max()) < 0.3 and float(mm.max()) < 1.0, (deg.tolist(), mm.tolist())
    kernel, plain = losses.mean(0).tolist()
    assert abs(kernel - plain) <= 2e-4 * plain, (kernel, plain)


@pytest.mark.gpu
def test_kernel_replays_in_a_graph():
    """A replay of a captured CUDA graph equals the eager call bit for bit,
    and the launch at capture counts."""
    dev = _card()
    args = [x.to(dev) for x in alignment._synthetic_rows(np.random.default_rng(3), 2, 5000)]
    eager = alignment.align_pose(*args, False, 1, 100, 1e-2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        alignment.align_pose(*args, False, 1, 100, 1e-2)   # warm-up on the side stream
        before = _build.launched("align")
        with torch.cuda.graph(graph, stream=side):
            out = alignment.align_pose(*args, False, 1, 100, 1e-2)
    assert _build.launched("align") == before + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(out, eager):
            assert torch.equal(x, y)


def _sphere_cap(h=480, w=640, radius=0.11, center=(0.05, -0.02, 0.82)):
    """A 22 cm sphere cap at 0.8 m under the REAL275 intrinsics, about 25k
    mask pixels, and a random RGB."""
    from cppf2_torch.eval.driver import REAL275_INTRINSICS as k

    rng = np.random.default_rng(0)
    cx, cy, cz = center
    ys, xs = np.mgrid[0:h, 0:w]
    d2 = (xs - (k[0, 2] - k[0, 0] * cx / cz)) ** 2 + (ys - (k[1, 2] - k[1, 1] * cy / cz)) ** 2
    mask = d2 < (radius * k[0, 0] / cz) ** 2
    bump = np.sqrt(np.maximum(radius ** 2 - d2 * (cz / k[0, 0]) ** 2, 0.0))
    depth = np.where(mask, cz - bump + rng.normal(0, 3e-4, (h, w)), 0.0).astype(np.float32)
    return rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8), depth, mask


@pytest.mark.gpu
def test_a_pose_program_replay_credits_one_launch():
    """One replay of a category's pose program (the production
    configuration, both branches as the two rows of one launch) credits
    exactly one K4 launch to the launch table, as it credits K2's four; the
    replay gives the first call's pose."""
    dev = _card()
    from cppf2_torch.config import PipelineConfig
    from cppf2_torch.eval import driver, programs

    ckpts = Path(__file__).resolve().parents[1] / "ckpts_r3"
    models = driver.load_category_models(str(ckpts), ["mug"], torch.bfloat16, dev)["mug"]
    pipe = PipelineConfig()
    rgb, depth, mask = _sphere_cap()
    draws = driver.draw_instance(depth.shape, mask, "mug", pipe, dev,
                                 torch.Generator(device=dev).manual_seed(0))

    def once():
        est = driver.estimate_instance(rgb, depth, mask, driver.REAL275_INTRINSICS, models, "mug",
                                       pipe, device=dev, draws=draws, use_visual=False)
        torch.cuda.synchronize()
        return est

    with programs.recorded() as used:
        first = once()   # warm-up, capture and a first replay of each program
        before = _build.snapshot()
        again = once()
    poses = [p for p, *_ in used.values() if p.key[0][0] == "pose"]
    assert len(poses) == 1 and poses[0].replays == 2
    assert poses[0].credited("align") == poses[0].credited("align", "cppf2_align_pose") == 1
    assert poses[0].credited("hist16", "cppf2_hist16_level_peak") == pipe.vote_levels
    gained = _build.since(before)
    assert gained[("align", "cppf2_align_pose")] == 1
    assert gained[("hist16", "cppf2_hist16_level_peak")] == pipe.vote_levels
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.gpu
def test_kernel_streams_a_slice_larger_than_shared_memory():
    """A slice that does not fit in shared memory (40,000 kept pairs, 8
    blocks a row) is read from device memory every step: the plain loop's
    poses after one step, the same bits twice, and after 100 steps the
    plain loop's float64 loss to 0.1%."""
    dev = _card()
    assert alignment.cluster_plan(2, 40000, 132) == (8, 10000, False)
    args = _on_card(np.random.default_rng(5), 2, 40000, dev)
    for steps in (1, 100):
        got = alignment.align_pose(*args, False, 1, steps, 1e-2)
        again = alignment.align_pose(*args, False, 1, steps, 1e-2)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        want = alignment.align_pose_plain(*args, False, 1, steps, 1e-2)
        if steps == 1:
            deg, mm = alignment._pose_gaps(got, want)
            assert float(deg.max()) < 1e-3 and float(mm.max()) < 1e-3, (deg.tolist(), mm.tolist())
        else:
            loss_k, loss_p = (alignment._row_losses64(args, r, False) for r in (got, want))
            assert abs(float(loss_k.mean()) - float(loss_p.mean())) <= 1e-3 * float(loss_p.mean())


@pytest.mark.gpu
def test_kernel_refuses_other_dtypes_on_card():
    """A CUDA tensor of another dtype raises; it never takes the plain loop.
    int32 indices give the bits of int64 ones."""
    dev = _card()
    args = [x.to(dev) for x in alignment._synthetic_rows(np.random.default_rng(2), 2, 100)]
    narrow = alignment.align_pose(args[0], args[1].int(), *args[2:], False)
    assert all(torch.equal(x, y) for x, y in zip(narrow, alignment.align_pose(*args, False)))
    before = _build.launched("align")
    with pytest.raises(ValueError, match="float32"):
        alignment.align_pose(*[a.double() if a.is_floating_point() else a for a in args], False)
    assert _build.launched("align") == before
    assert math.isfinite(float(alignment.align_pose(*args, False).loss[0]))
