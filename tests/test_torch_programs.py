"""The JAX driver's program layer in the port, on the CPU.

`cppf2_torch/eval/programs.py` captures each of the driver's programs once
as a CUDA graph on the card and runs it eagerly on the CPU; the driver keeps
the JAX driver's bucket padding, chunking and ViT packing
(`cppf2_tpu/eval/driver.py:354-591`). Held here: the packing and the chunks
against the JAX package, a padded chunk's real rows against the unpadded
chunk to the bit, the gather-cut crop windows against slices to the bit, the
program cache's keys, and that no program body reads the device back or
builds a tensor from host values once its constants exist (either would
break a capture).
"""

import weakref

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cppf2_torch.config import PipelineConfig as TPipe
from cppf2_torch.eval import driver as tdriver
from cppf2_torch.eval import parallel_eval as tparallel
from cppf2_torch.eval import programs
from cppf2_torch.infer import frontend as tfront
from cppf2_torch.models import dinov2 as tdino
from cppf2_torch.models.porting import load_vit
from cppf2_tpu.config import PipelineConfig as JPipe
from cppf2_tpu.eval import driver as jdriver
from cppf2_tpu.models import dinov2 as jdino
from test_torch_frame_driver import (H, K, OUT, PIPE, STRIDE, VIT, W, _cap, _instance_draws,
                                     _rt_angle_deg)

FIVE = [(-0.09, -0.04, 0.7), (0.0, -0.05, 0.72), (0.09, -0.03, 0.69), (-0.05, 0.05, 0.71),
        (0.06, 0.05, 0.7)]


def _five_mugs(radius=0.04):
    """Five mugs (sphere caps near 0.7 m) of one crop tier on a 240 x 320 frame."""
    rng = np.random.default_rng(7)
    depth = np.zeros((H, W), np.float32)
    dets = [("mug", _cap(depth, c, radius, rng)) for c in FIVE]
    rgb = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    return rgb, depth, dets


def _tierless(depth):
    """A 318-pixel-wide strip that fits no crop tier, its depth a wave at
    0.8 m written into a copy of `depth`: (depth, mask)."""
    rng = np.random.default_rng(1)
    big = np.zeros((H, W), bool)
    big[60:180, 1:319] = True
    wave = 0.8 + 0.05 * np.sin(np.mgrid[0:H, 0:W][1] / 40.0) + rng.normal(0, 3e-4, (H, W))
    return np.where(big, wave, depth).astype(np.float32), big


def _extractor(vit_like):
    """A port DinoFeatureExtractor at the tests' stride and crop size whose
    backbone has the weights of `vit_like`."""
    ext = tdino.DinoFeatureExtractor(cfg=tdino.ViTConfig(**VIT), stride=STRIDE, out_size=OUT,
                                     device="cpu")
    ext.model.load_state_dict(vit_like.state_dict())
    ext.ready = True
    return ext


def _rows_args(depth, dets, draws, crop):
    """The inputs of a rank's block program (`parallel_eval._rows_program`)."""
    masks = np.stack([m for _, m in dets])
    origins = torch.tensor([tfront.crop_origin(m, (H, W), crop) for m in masks], dtype=torch.int32)
    return (torch.from_numpy(np.stack([depth] * len(dets))), torch.from_numpy(masks), origins,
            torch.from_numpy(K), *tdriver._stacked(draws))


def _chunk_draws(key, dets, hw, buckets):
    """One InstanceDraws per detection from the keys the JAX `dispatch_frame`
    hands out when it chunks a group (`driver.py:534-545`, `:579-580`): per
    chunk one split of the frame key, then the chunk's bucket of keys; the
    padded rows' keys are never used."""
    draws = [None] * len(dets)
    groups = {}
    for idx, (name, mask) in enumerate(dets):
        groups.setdefault((name, tfront.auto_crop(mask)), []).append(idx)
    for (name, tier), members in groups.items():
        for lo in range(0, len(members), buckets[-1]):
            chunk = members[lo:lo + buckets[-1]]
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, next(b for b in buckets if b >= len(chunk)))
            for k, idx in zip(keys, chunk):
                draws[idx] = _instance_draws(k, hw, tier)
    return draws


@pytest.fixture(scope="module")
def five_references():
    """Five mugs of a given radius through the JAX `dispatch_frame` at
    buckets (1, 2), and both packages' models and ViT with the same
    weights; made once a radius."""
    made = {}

    def get(radius):
        if radius not in made:
            rgb, depth, dets = _five_mugs(radius)
            ext = jdino.DinoFeatureExtractor(cfg=jdino.ViTConfig(**VIT, attn_impl="pallas",
                                                                 attn_block_q=128),
                                             stride=STRIDE, out_size=OUT)
            ext.init_random(hw=(OUT, OUT))
            jmodels = jdriver.load_category_models("ckpts_r3", ["mug"], infer_dtype="float32")
            key = jax.random.key(11)
            pends = jdriver.dispatch_frame(rgb, depth, dets, K, jmodels, JPipe(**PIPE), key,
                                           dino_extractor=ext, buckets=(1, 2))
            chunks = [(p.idxs, int(np.shape(p.dev[0])[0])) for p in pends]
            want = jdriver.fetch_frames(pends)
            tvit = load_vit(tdino.DinoViT(tdino.ViTConfig(**VIT)), jax.device_get(ext.params)).eval()
            tmodels = tdriver.load_category_models("ckpts_r3", ["mug"], torch.float32, "cpu")
            made[radius] = (rgb, depth, dets, chunks, want, tvit, tmodels,
                            _chunk_draws(key, dets, depth.shape, (1, 2)))
        return made[radius]

    return get


@pytest.fixture(scope="module")
def five_reference(five_references):
    """The five 4 cm mugs of `five_references`."""
    return five_references(0.04)


def test_pack_vit_chunks_matches_jax():
    """First-fit-decreasing packing of chunk sizes into ViT forwards, on 200
    seeded lists of sizes and caps: the same packs, chunk for chunk."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        cap = int(rng.integers(1, 17))
        batches = [int(b) for b in rng.integers(1, cap + 1, size=int(rng.integers(0, 12)))]
        assert tdriver._pack_vit_chunks(batches, cap) == jdriver._pack_vit_chunks(batches, cap)


@pytest.mark.parametrize("radius", [0.04, 0.03])
def test_dispatch_frame_chunks_and_pads_as_jax(five_references, radius):
    """Five mugs of one group at buckets (1, 2), caps of 4 cm and of 3 cm:
    chunks (0, 1), (2, 3) and (4,) padded to 2, 2 and 1 rows in both
    packages, the padded rows dropped at fetch, and the poses at
    `test_dispatch_frame_matches_jax`'s tolerances (R 0.5 deg, T 2 mm,
    scales rtol 1e-3, loss rtol 0.05). At 3 cm two rim rows had another
    neighbour set while the kNN key rounded its column norms as the eager
    JAX call does, and an instance's rotation came out 51.46 deg off the
    jitted JAX driver's."""
    rgb, depth, dets, chunks, want, tvit, tmodels, draws = five_references(radius)
    pends = tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, TPipe(**PIPE), vit=tvit,
                                   device="cpu", draws=draws, stride=STRIDE, out_size=OUT,
                                   buckets=(1, 2))
    assert [(p.idxs, p.dev.shape[0]) for p in pends] == chunks == [((0, 1), 2), ((2, 3), 2), ((4,), 1)]
    got = tdriver.fetch_frames(pends)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4]
    for i in range(5):
        (rt, scales, loss), (jrt, jscales, jloss) = got[i], want[i]
        assert _rt_angle_deg(rt, jrt) < 0.5
        np.testing.assert_allclose(rt[:3, 3], jrt[:3, 3], atol=2e-3)
        np.testing.assert_allclose(np.cbrt(np.linalg.det(rt[:3, :3])),
                                   np.cbrt(np.linalg.det(jrt[:3, :3])), rtol=1e-3)
        np.testing.assert_allclose(scales, jscales, rtol=1e-3)
        np.testing.assert_allclose(loss, jloss, rtol=0.05)


@pytest.mark.parametrize("visual", [False, True])
def test_padded_rows_leave_the_real_rows_bit_equal(five_reference, visual, monkeypatch):
    """Three mugs as one chunk of 3 and as one chunk padded to 4 (the last
    mug's mask, origin and draws again): the three real rows of the packed
    output are equal to the bit in float32, the alignment included, and the
    padded row equals the one it repeats. With the visual branch the ViT
    runs each crop alone: a batched float32 forward on the CPU rounds a
    crop's tokens by the batch's size (MKL's product with the transposed
    weight), which is the ViT's and not the padding's."""
    rgb, depth, dets, _, _, tvit, tmodels, _ = five_reference
    pipe = TPipe(**PIPE)
    grid_of = tdriver.bbox_crop_token_grid

    def crop_by_crop(vit, rgb_t, masks, **kw):
        parts = [grid_of(vit, rgb_t, m, **kw) for m in masks]
        return torch.stack([g for g, _ in parts]), torch.stack([t for _, t in parts])

    monkeypatch.setattr(tdriver, "bbox_crop_token_grid", crop_by_crop)
    draws = [tdriver.draw_instance(depth.shape, m, c, pipe, "cpu", torch.Generator().manual_seed(i))
             for i, (c, m) in enumerate(dets[:3])]
    kw = dict(device="cpu", draws=draws, stride=STRIDE, out_size=OUT, use_visual=visual,
              vit=tvit if visual else None)
    three = tdriver.dispatch_frame(rgb, depth, dets[:3], K, tmodels, pipe, buckets=(3,), **kw)
    four = tdriver.dispatch_frame(rgb, depth, dets[:3], K, tmodels, pipe, buckets=(4,), **kw)
    assert [p.dev.shape[0] for p in three + four] == [3, 4] and four[0].idxs == (0, 1, 2)
    assert torch.equal(four[0].dev[:3], three[0].dev)
    assert torch.equal(four[0].dev[3], four[0].dev[2])
    assert tdriver.fetch_frames(four).keys() == {0, 1, 2}


@pytest.mark.parametrize("b", [1, 3])
def test_gather_cut_windows_equal_slices(b):
    """`cut_windows` against host slices at B = 1 and 3, windows on the
    frame's edges (a mask in a corner, across a border, in the middle) and a
    320 tier taller than the 240-row frame; float depth and bool masks."""
    rng = np.random.default_rng(b)
    depth = rng.random((b, H, W), dtype=np.float32)
    masks = np.zeros((3, H, W), bool)
    masks[0, :20, :30] = True
    masks[1, 200:, 290:] = True
    masks[2, 100:140, 150:170] = True
    for crop in (256, 320):
        hw = tfront.window_shape((H, W), crop)
        origins = [tfront.crop_origin(m, (H, W), crop) for m in masks[:b]]
        o_t = torch.tensor(origins, dtype=torch.int32)
        for x in (depth, masks[:b]):
            got = tfront.cut_windows(torch.from_numpy(x), o_t, hw)
            want = torch.stack([torch.from_numpy(x[i, y0:y0 + hw[0], x0:x0 + hw[1]])
                                for i, (y0, x0) in enumerate(origins)])
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_program_cache_keys(five_reference, monkeypatch):
    """On the CPU: a key and the inputs' shapes find one Program, which runs
    eagerly; a group program is found again with another extractor of equal
    behaviour (config, stride, crop size, sampling form); a new frame shape
    makes new programs; `disable_capture()` nests."""
    rgb, depth, dets, _, _, _, _, _ = five_reference
    pipe = TPipe(**PIPE)
    cache = {}
    x = torch.arange(6.0)
    a = programs.program(cache, ("k", 1), lambda t: t * 2, (x,))
    assert programs.program(cache, ("k", 1), lambda t: t * 3, (x,)) is a
    assert programs.program(cache, ("k", 1), lambda t: t * 2, (x[:4],)) is not a
    assert programs.program(cache, ("k", 2), lambda t: t * 2, (x,)) is not a
    assert torch.equal(a(x), x * 2) and a.graph is None and len(cache) == 3

    models = tdriver.load_category_models("ckpts_r3", ["mug"], torch.float32, "cpu")
    mug = models["mug"]
    cfg = tdino.ViTConfig(**VIT)
    exts = [tdino.DinoFeatureExtractor(cfg=cfg, stride=STRIDE, out_size=OUT, device="cpu")
            .init_random(torch.Generator().manual_seed(s)) for s in (1, 2)]
    kw = dict(device="cpu", generator=torch.Generator().manual_seed(0), buckets=(1, 2))
    tdriver.dispatch_frame(rgb, depth, dets[:3], K, models, pipe, dino_extractor=exts[0], **kw)
    first = dict(mug._programs)
    assert len(first) == 2    # chunks of 2 and 1 rows
    tdriver.dispatch_frame(rgb, depth, dets[:3], K, models, pipe, dino_extractor=exts[1], **kw)
    assert mug._programs == first
    assert all(len(tdriver._VIT_STAGES[e.model]) == 2 for e in exts)   # packs (2,) and (1,)

    monkeypatch.setattr(tdriver, "_FRONTENDS", {})
    kw = dict(device="cpu", use_visual=False, run_opt=False)
    tdriver.dispatch_instance(rgb, depth, dets[0][1], K, mug, "mug", pipe,
                              generator=torch.Generator().manual_seed(0), **kw)
    n_pose = len(mug._programs)
    tdriver.dispatch_instance(rgb, depth, dets[1][1], K, mug, "mug", pipe,
                              generator=torch.Generator().manual_seed(1), **kw)
    assert len(tdriver._FRONTENDS) == 1 and len(mug._programs) == n_pose
    taller = np.concatenate([depth, np.zeros((16, W), np.float32)])
    mask = np.concatenate([dets[0][1], np.zeros((16, W), bool)])
    tdriver.dispatch_instance(np.zeros((H + 16, W, 3), np.uint8), taller, mask, K, models["mug"],
                              "mug", pipe, generator=torch.Generator().manual_seed(0), **kw)
    assert len(tdriver._FRONTENDS) == 2

    assert programs.capture_enabled()
    with programs.disable_capture():
        with programs.disable_capture():
            assert not programs.capture_enabled()
        assert not programs.capture_enabled()
    assert programs.capture_enabled()


def test_serving_program_cache_keys(five_reference, monkeypatch):
    """On the CPU: one instance visual-stage program per route and backbone
    (the bbox-crop ViT's, the extractor's), found again for another
    instance; one block program of the parallel evaluator per block shape
    (a block of 2 and a short one of 1), found again for a second block of
    2, its rows equal to the first's."""
    rgb, depth, dets, _, _, tvit, tmodels, _ = five_reference
    pipe = TPipe(**PIPE)
    monkeypatch.setattr(tdriver, "_VISUALS", weakref.WeakKeyDictionary())
    ext = _extractor(tvit)
    for route in (dict(vit=tvit), dict(dino_extractor=ext)):
        for i in (0, 1):
            tdriver.estimate_instance(rgb, depth, dets[i][1], K, tmodels["mug"], "mug", pipe,
                                      generator=torch.Generator().manual_seed(i), device="cpu",
                                      stride=STRIDE, out_size=OUT, run_opt=False, **route)
    kinds = {b: [k[0][:2] for k in tdriver._VISUALS[b]] for b in (tvit, ext.model)}
    assert kinds == {tvit: [("visual", "vit")], ext.model: [("visual", "extractor")]}
    assert [p.eager_runs for b in kinds for p in tdriver._VISUALS[b].values()] == [2, 2]

    mug = tmodels["mug"]
    crop = tfront.auto_crop(dets[0][1])
    draws = [tdriver.draw_instance((H, W), m, "mug", pipe, "cpu", torch.Generator().manual_seed(i),
                                   crop=crop) for i, (_, m) in enumerate(dets)]

    def block(lo, hi):
        args = _rows_args(depth, dets[lo:hi], draws[lo:hi], crop)
        return tparallel._rows_program(mug, tdriver.get_category("mug"), pipe, False, False, True,
                                       crop, args)(*args)

    first = block(0, 2)
    short = block(2, 3)
    again = block(0, 2)
    rows = [k for k in mug._programs if k[0][0] == "rows"]
    assert len(rows) == 2 and first.shape == (2, 22) and short.shape == (1, 22)
    assert torch.equal(first, again)


def test_programs_do_not_nest():
    """A program called while another one's body runs raises, naming both,
    on the CPU as on the card (a capture inside a capture fails there), and
    inside `disable_capture()` too; the guard is released after the raise."""
    cache = {}
    x = torch.arange(4.0)
    inner = programs.program(cache, ("inner",), lambda t: t + 1, (x,))
    outer = programs.program(cache, ("outer",), lambda t: inner(t) * 2, (x,))
    with pytest.raises(RuntimeError, match=r"program \(\('inner',\).*called inside program "
                                           r"\(\('outer',\)"):
        outer(x)
    with programs.disable_capture(), pytest.raises(RuntimeError, match="called inside program"):
        outer(x)
    assert torch.equal(inner(x), x + 1) and not programs._running


class _HostReads(TorchDispatchMode):
    """Records the operators that read the device back or build a tensor
    from host values: a CUDA graph capture fails on either."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name.startswith(("aten.index.", "aten.index_put")) and any(
            torch.is_tensor(i) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if bool_index or any(k in name for k in ("_local_scalar_dense", "nonzero", "masked_select",
                                                 "lift_fresh", "unique", "repeat_interleave.Tensor")):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_program_bodies_make_no_host_reads(five_reference, monkeypatch):
    """Every program the driver runs, called a second time: the ViT stage,
    the group, the instance frontend (at a crop tier and at crop None, the
    singles route of a mask that fits no tier), the instance visual stage on
    both routes, the ensemble, the extractor and the parallel evaluator's
    block. None of its operators reads the device back or builds a tensor
    from host values."""
    rgb, depth, dets, _, _, tvit, tmodels, _ = five_reference
    pipe = TPipe(**PIPE)
    ext = _extractor(tvit)
    wide_depth, wide = _tierless(depth)
    crop = tfront.auto_crop(dets[0][1])
    draws = [tdriver.draw_instance((H, W), m, "mug", pipe, "cpu", torch.Generator().manual_seed(i),
                                   crop=crop) for i, (_, m) in enumerate(dets[:2])]
    img = torch.rand(OUT, OUT, 3, generator=torch.Generator().manual_seed(0))
    bodies = []
    call = programs.Program.__call__

    def watched(self, *args):
        mode = _HostReads()
        with mode:
            out = call(self, *args)
        bodies.append((self.key[0][0], mode.seen))
        return out

    def run():
        gen = torch.Generator().manual_seed(3)
        kw = dict(vit=tvit, device="cpu", stride=STRIDE, out_size=OUT)
        tdriver.fetch_frames(tdriver.dispatch_frame(rgb, depth, dets, K, tmodels, pipe, generator=gen,
                                                    buckets=(1, 2, 4), **kw))
        tdriver.estimate_instance(rgb, depth, dets[0][1], K, tmodels["mug"], "mug", pipe,
                                  generator=gen, **kw)
        tdriver.fetch_frames(tdriver.dispatch_frame(rgb, wide_depth, [("mug", wide), dets[0]], K,
                                                    tmodels, pipe, generator=gen, device="cpu",
                                                    dino_extractor=ext))
        ext(img, torch.rand(7, 2, generator=gen) * OUT)
        args = _rows_args(depth, dets[:2], draws, crop)
        tparallel._rows_program(tmodels["mug"], tdriver.get_category("mug"), pipe, True, False,
                                True, crop, args)(*args)

    run()
    monkeypatch.setattr(programs.Program, "__call__", watched)
    run()
    assert {name for name, _ in bodies} == {"vit", "frame", "frontend", "pose", "visual",
                                            "extractor", "rows"}
    assert all(not seen for _, seen in bodies), bodies


def test_a_capture_counts_in_the_frame_record_with_its_host_ms(monkeypatch):
    """A call that captures is a `capture` span and adds a capture and its
    host ms to the open frame's counters; every call that replays adds a
    replay, as `copy_in`, `launch` and `clone` spans. The card's capture and
    graph are stood in for (this machine has no card)."""
    from types import SimpleNamespace

    from cppf2_torch.utils import profiling

    def capture(self, leaves, spec, tensors):
        self.static = [x.clone() for x in tensors]
        self.graph = SimpleNamespace(replay=lambda: None)
        self.outputs = self.fn(*self.static)
        self.capture_ms = 12.5

    monkeypatch.setattr(programs, "_eager", lambda tensors: False)
    monkeypatch.setattr(programs.Program, "_capture", capture)
    x = torch.arange(4.0)
    prog = programs.program({}, ("double",), lambda t: t * 2, (x,))
    with profiling.frame_span("dispatch"):   # takes what earlier calls left outside a frame
        pass
    with profiling.frame_span("dispatch"):
        first = prog(x)
        again = prog(x + 1)
    rec = profiling.frames()[-1]
    assert torch.equal(first, x * 2) and torch.equal(again, x * 2)   # the stand-in graph does nothing
    assert rec.counters == {"captures": 1, "capture_ms": 12.5, "replays": 2}
    assert {k: v[0] for k, v in rec.spans.items()} == {"dispatch": 1, "capture": 1, "copy_in": 1,
                                                       "launch": 2, "clone": 2}
    assert prog.replays == 2 and prog.eager_runs == 0


def test_an_eager_run_counts_in_the_frame_record():
    from cppf2_torch.utils import profiling

    x = torch.arange(4.0)
    prog = programs.program({}, ("double",), lambda t: t * 2, (x,))
    with profiling.frame_span("dispatch"):   # takes what earlier calls left outside a frame
        pass
    with profiling.frame_span("dispatch"):
        prog(x)
    assert profiling.frames()[-1].counters == {"eager_runs": 1}


def test_stages_launch_nothing_on_the_cpu_and_do_not_nest(monkeypatch):
    """`stage` launches its marker and `stage_mark_end` only for a CUDA
    device (the launch stood in for here), raises when nested, names both
    stages, and is released after the raise."""
    from cppf2_torch.utils import profiling

    launched = []
    monkeypatch.setattr(profiling, "_mark", lambda which, dev: launched.append((which, dev.type)))
    with profiling.stage_log() as log:
        with profiling.stage("align", "cpu"):
            pass
        assert launched == []
        with profiling.stage("align", torch.device("cuda")):
            pass
        align = profiling.STAGES.index("align")
        assert launched == [(align, "cuda"), (len(profiling.STAGES), "cuda")]
        with pytest.raises(RuntimeError, match="stage 'vit' opened inside stage 'targets'"):
            with profiling.stage("targets", "cpu"):
                with profiling.stage("vit", "cpu"):
                    pass
        with profiling.stage("finish", "cpu"):
            pass
    assert log == ["align", "align", "targets", "finish"]
    with pytest.raises(ValueError):
        profiling.stage("nowhere", "cpu")


def test_the_marker_kernels_follow_the_stages_in_order():
    """`csrc/stage.cu` defines one `stage_mark_<stage>` kernel per stage, in
    `profiling.STAGES`' order (the launch entry takes a stage's index), then
    `stage_mark_end`; no name is one the kernel rooflines look for."""
    import re
    from pathlib import Path

    from cppf2_torch.utils import profiling

    src = (Path(programs.__file__).resolve().parents[1] / "csrc" / "stage.cu").read_text()
    body = src[src.index("#define STAGES(X)"):src.index("#define DEFINE_MARKER")]
    names = re.findall(r"X\((\w+)\)", body)
    assert names == [*profiling.STAGES, "end"]
    assert not any(k in n for n in names for k in ("mha_fwd_kernel", "hist16_kernel"))
