"""The frontend's kNN selection kernel K6 (`csrc/knn.cu`) and its plain version.

On the CPU: `knn_select_plain`, the kernel's arithmetic and tile-by-tile
selection in plain PyTorch, against the plain route (`torch.topk` over the
whole block of keys), and the wrapper's input check as the card's route calls
it. On a CUDA card (marked `gpu`, skipped elsewhere): the kernel against the
plain route on the same card, inside a captured graph, and its launch counter
credited by a program's replay.
"""

import numpy as np
import pytest
import torch

from cppf2_torch.ops import _build
from cppf2_torch.ops import neighbors as nb

RADIUS = 0.02


def _cloud(rng, b, n):
    """(B, N, 3) float32 clouds and (B, N) validity: half the points dense on
    a curved 4 cm patch (hundreds in radius), a quarter on a 3 mm grid (keys
    of one level, so columns break the ties), the rest scattered through a
    30 cm box (rows with fewer than k points in radius), a few duplicates, and
    a tenth of the points invalid (parked)."""
    clouds = []
    for _ in range(b):
        n1, n2 = n // 2, n // 4
        xy = rng.uniform(-0.02, 0.02, size=(n1, 2))
        patch = np.concatenate([xy, 0.8 + 2.0 * np.sum(xy * xy, -1, keepdims=True)], -1)
        side = int(np.ceil(np.sqrt(n2)))
        gy, gx = np.divmod(np.arange(n2), side)
        grid = np.stack([0.05 + 0.003 * gx, -0.03 + 0.003 * gy, np.full(n2, 0.9)], -1)
        rest = rng.uniform([-0.15, -0.15, 0.6], [0.15, 0.15, 0.9], size=(n - n1 - n2, 3))
        pts = np.concatenate([patch, grid, rest])[rng.permutation(n)]
        pts[rng.integers(0, n, 4)] = pts[rng.integers(0, n, 4)]
        clouds.append(pts)
    return (torch.from_numpy(np.stack(clouds).astype(np.float32)),
            torch.from_numpy(rng.random((b, n)) > 0.1))


def _parked(points, valid):
    """The kernel's inputs as the wrapper makes them."""
    pts = torch.where(valid[..., None], points, torch.full((), 1e6, dtype=points.dtype,
                                                           device=points.device))
    return pts, nb._sum_sq_fma(pts)


@pytest.mark.parametrize("b,n,k", [(3, 513, 24), (1, 513, 96), (3, 1024, 48), (1, 1024, 24),
                                   (3, 1024, 96), (1, 8192, 48)])
def test_plain_selection_matches_the_topk_route(b, n, k):
    """The kernel's formula and selection, tile by tile, select the plain
    route's integers exactly: parked points, rows short of k neighbours in
    radius and rows of tied levels among them."""
    points, valid = _cloud(np.random.default_rng(1000 * n + 10 * k + b), b, n)
    pts, sq = _parked(points, valid)
    want = nb.knn_radius_neighbors(points, valid, RADIUS, k)
    got = nb.knn_select_plain(pts, sq, RADIUS, k)
    assert got.dtype == torch.int64 and got.shape == (b, n, k)
    assert torch.equal(got, want.idx)
    in_radius = want.valid.sum(-1)
    assert bool((in_radius[valid] < k).any()) and bool((in_radius == k).any())


def test_kernel_input_check():
    """The card's route checks its inputs before it launches, and raises on
    what K6 does not take: k above 128 (after k is cut to N), points or
    norms not float32; the exact route never reaches the kernel. Meta
    tensors take the card's route (they are not CPU tensors), which stops at
    the device check."""
    points, valid = _cloud(np.random.default_rng(3), 2, 300)
    pts, sq = _parked(points, valid)
    nb._check_select(pts, sq, 128)
    with pytest.raises(ValueError, match="1 to 128"):
        nb._check_select(pts, sq, 129)
    with pytest.raises(ValueError, match="float32"):
        nb._check_select(pts.double(), sq, 48)
    with pytest.raises(ValueError, match="float32"):
        nb._check_select(pts, sq.double(), 48)
    meta_pts, meta_valid = points.to("meta"), valid.to("meta")
    with pytest.raises(ValueError, match="1 to 128"):
        nb.knn_radius_neighbors(meta_pts, meta_valid, RADIUS, 200)
    with pytest.raises(ValueError, match="float32"):
        nb.knn_radius_neighbors(meta_pts.double(), meta_valid, RADIUS, 48)
    with pytest.raises(ValueError, match="unsupported device"):
        nb.knn_radius_neighbors(meta_pts, meta_valid, RADIUS, 48)
    with pytest.raises(ValueError, match="unsupported device"):   # k cut to N = 100 first
        nb.knn_radius_neighbors(meta_pts[:, :100], meta_valid[:, :100], RADIUS, 200)
    out = nb.knn_radius_neighbors(meta_pts, meta_valid, RADIUS, 200, exact=True)
    assert out.idx.shape == (2, 300, 200)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kNN kernel has no CPU mode")
    from cppf2_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,k", [(1, 8192, 48), (2, 8192, 48), (8, 8192, 48), (3, 1024, 24),
                                   (1, 4097, 96)])
def test_kernel_matches_the_plain_route_on_card(b, n, k):
    """K6's indices equal the plain route's on the card exactly, parked
    points included, and so do the neighbours' offsets, distances and
    validity; one launch a call, for every instance."""
    dev = _card()
    points, valid = (x.to(dev) for x in _cloud(np.random.default_rng(n + k + b), b, n))
    pts, sq = _parked(points, valid)
    want = nb._plain_neighbors(pts, sq, RADIUS, k, False)
    before = _build.launched("knn")
    got = nb.knn_radius_neighbors(points, valid, RADIUS, k)
    torch.cuda.synchronize()
    assert _build.launched("knn") == before + 1
    assert torch.equal(got.idx, want[0])
    assert torch.equal(got.dist, want[1]) and torch.equal(got.rel, want[2])
    assert torch.equal(got.valid, (want[1] <= RADIUS) & valid[..., None])
    assert torch.equal(nb.knn_select_plain(pts, sq, RADIUS, k), got.idx)


@pytest.mark.gpu
def test_kernel_replays_in_a_graph():
    """A replay of a captured graph gives the eager call's indices, on new
    inputs copied into the captured ones too."""
    dev = _card()
    rng = np.random.default_rng(5)
    inputs = [_parked(*(x.to(dev) for x in _cloud(rng, 2, 8192))) for _ in range(2)]
    pts, sq = (x.clone() for x in inputs[0])
    eager = [nb.knn_select(p, s, RADIUS, 48) for p, s in inputs]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nb.knn_select(pts, sq, RADIUS, 48)   # warm-up on the side stream
        with torch.cuda.graph(graph, stream=side):
            out = nb.knn_select(pts, sq, RADIUS, 48)
    for (p, s), want in zip(inputs, eager):
        pts.copy_(p)
        sq.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
def test_a_program_replay_credits_one_launch():
    """A captured program that runs the frontend's kNN credits one K6
    launch at every replay."""
    dev = _card()
    from cppf2_torch.eval import programs

    points, valid = (x.to(dev) for x in _cloud(np.random.default_rng(6), 2, 8192))
    cache = {}

    def body(p, v):
        return nb.knn_radius_neighbors(p, v, RADIUS, 48).idx

    prog = programs.program(cache, "knn", body, (points, valid))
    first = prog(points, valid)   # warm-up, capture and a first replay
    assert prog.credited("knn") == 1
    before = _build.launched("knn")
    for _ in range(3):
        again = prog(points, valid)
        assert torch.equal(again, first)
    assert _build.launched("knn") == before + 3
