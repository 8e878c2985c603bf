"""The port's training-data path against the JAX package on the CPU: the
procedural meshes and the numpy stream, surface sampling, the mesh readers,
lighting and texture, both renderers, the frame tail, the synthetic frame
generator and the record dump of rendered frames.

Device-side draws come from `jax_frame_draws`, which makes the numbers the
reference's `jax.random` keys give, so both packages render, downsample and
shade with the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import special_ortho_group

from cppf2_torch.config import CATEGORIES as TCATS
from cppf2_torch.core import geometry as tgeo
from cppf2_torch.data import render as trender
from cppf2_torch.data import shapes as tshapes
from cppf2_torch.data import synthetic as tsynth
from cppf2_torch.data.records import dump_frames
from cppf2_torch.ops import neighbors as tneighbors
from cppf2_torch.ops import shot as tshot
from cppf2_tpu.config import CATEGORIES as JCATS
from cppf2_tpu.core import geometry as jgeo
from cppf2_tpu.data import render as jrender
from cppf2_tpu.data import shapes as jshapes
from cppf2_tpu.data import synthetic as jsynth
from cppf2_tpu.data.records import RecordReader as JRecordReader
from cppf2_tpu.ops import neighbors as jneighbors
from cppf2_tpu.ops import shot as jshot

SMALL = dict(n_max=128, shot_k=16, surface_samples=4000)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_lighting_draws(light_key, texture=True):
    """(lighting draws, albedo draws) of the reference's light key: one split
    into a lighting and an albedo key, then `sample_lighting`'s split in 3
    and `procedural_albedo`'s split in 4."""
    lk, ak = jax.random.split(light_key)
    k1, k2, k3 = jax.random.split(lk, 3)
    light = (t(jax.random.normal(k1, (3,))), t(jax.random.uniform(k2, (), minval=0.5, maxval=1.0)),
             t(jax.random.uniform(k3, (), minval=0.05, maxval=0.3)))
    if not texture:
        return light, None
    kd, kf, kp, ka = jax.random.split(ak, 4)
    return light, trender.AlbedoDraw(
        t(jax.random.normal(kd, (4, 3))), t(jax.random.uniform(kf, (4,), minval=1.5, maxval=3.0)),
        t(jax.random.uniform(kp, (4,), minval=0.0, maxval=2 * jnp.pi)),
        t(jax.random.uniform(ka, (4,), minval=0.3, maxval=1.0)))


def jax_frame_draws(frame_seed, light_seed, n_pixels, texture, device):
    """A `draw_fn` with the reference's numbers: the voxel draws of
    key(frame_seed) (`voxel_downsample`'s permutation and fold_in(key, 1)
    priorities) and the lighting and texture of key(light_seed)."""
    key = jax.random.key(frame_seed)
    perm = t(jax.random.permutation(key, n_pixels))
    prio = t(jax.random.uniform(jax.random.fold_in(key, 1), (n_pixels,)))
    if light_seed is None:
        return tsynth.FrameDraws(perm, prio, None, None)
    return tsynth.FrameDraws(perm, prio, *jax_lighting_draws(jax.random.key(light_seed), texture))


# ---------------------------------------------------------------------------
# meshes, the numpy stream, the mesh readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("category", sorted(JCATS))
def test_category_meshes_bit_for_bit(category):
    """Five meshes from one generator, with and without the meta: vertices,
    faces and meta equal, and the generators in the same state after."""
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for i in range(5):
        meta = i % 2 == 0
        want = jshapes.make_category_mesh(category, jr, return_meta=meta)
        got = tshapes.make_category_mesh(category, tr, return_meta=meta)
        (wv, wf), (gv, gf) = (want[0], got[0]) if meta else (want, got)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)
        assert gv.dtype == np.float32 and gf.dtype == np.int32
        if meta:
            assert got[1] == want[1]
    assert tr.bit_generator.state == jr.bit_generator.state


def test_subdivide_mesh_and_sample_surface():
    """Exactly equal: subdivision to 1/48 and under a face budget the loop
    stops at, area-weighted samples and their normals, and the stream after."""
    mesh = jshapes.make_category_mesh("mug", np.random.default_rng(2))
    for max_edge, max_faces in ((1 / 48, 65536), (1 / 200, 3000)):
        want = jshapes.subdivide_mesh(mesh, max_edge, max_faces)
        got = tshapes.subdivide_mesh(mesh, max_edge, max_faces)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(tshapes.subdivide_mesh(mesh, 1 / 200, 3000)[1]) <= 3000
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    for g, w in zip(tshapes.sample_surface(mesh, 3000, tr), jshapes.sample_surface(mesh, 3000, jr)):
        np.testing.assert_array_equal(g, w)
    assert tr.bit_generator.state == jr.bit_generator.state


def test_mesh_readers_and_split_files(tmp_path):
    """OBJ (texture and normal indices, negative indices, a quad fanned into
    two triangles, comments) and ASCII PLY (extra vertex properties, a quad):
    the same arrays as the reference's readers."""
    obj = tmp_path / "m.obj"
    obj.write_text("# a mesh\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nvt 0 0\nvn 0 0 1\n"
                   "f 1/1/1 2/1/1 3/1/1\nf -4 -2 -1\nf 1 2 3 4\n")
    ply = tmp_path / "m.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
                   "property float z\nproperty uchar red\nelement face 2\n"
                   "property list uchar int vertex_indices\nend_header\n"
                   "0 0 0 255\n1 0 0 0\n1 1 0 9\n0 1 0.25 1\n3 0 1 2\n4 0 1 2 3\n")
    for reader in ("load_obj", "load_ply"):
        path = str(obj if reader == "load_obj" else ply)
        for g, w in zip(getattr(tshapes, reader)(path), getattr(jshapes, reader)(path)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    split = tmp_path / "split.txt"
    split.write_text("6 02880940/abc\n1 02876657/def\n6 03797390/ghi\n")
    assert tshapes.load_shapenet_split(str(split), 6) == jshapes.load_shapenet_split(str(split), 6)
    assert tshapes.shapenet_model_path("/r", "6/abc") == jshapes.shapenet_model_path("/r", "6/abc")
    rgb = np.random.default_rng(0).uniform(size=(4, 5, 3))
    np.testing.assert_array_equal(tshapes.rgb2gray(rgb), jshapes.rgb2gray(rgb))


def test_rotations_and_symmetry_maps():
    """rotx / roty / rotz exact; map_sym about each axis and
    map_sym_discrete within 1e-6 on random rotations."""
    for name in ("rotx", "roty", "rotz"):
        for a in (0.3, -2.1, np.pi / 2):
            np.testing.assert_array_equal(getattr(tgeo, name)(a).numpy(), np.asarray(getattr(jgeo, name)(a)))
    rng = np.random.default_rng(0)
    rots = special_ortho_group.rvs(3, size=20, random_state=rng).astype(np.float32)
    group = special_ortho_group.rvs(3, size=4, random_state=rng).astype(np.float32)
    for r in rots:
        for axis in range(3):
            np.testing.assert_allclose(tgeo.map_sym(t(r), axis).numpy(),
                                       np.asarray(jgeo.map_sym(jnp.asarray(r), axis)), atol=1e-6)
        np.testing.assert_allclose(tgeo.map_sym_discrete(t(r), t(group)).numpy(),
                                   np.asarray(jgeo.map_sym_discrete(jnp.asarray(r), jnp.asarray(group))),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# lighting, texture, the renderers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_lighting_and_albedo_under_jax_draws(seed):
    """The applies on the reference's draws: lighting and the albedo at 2,000
    canonical positions within 1e-6; the default lighting too."""
    key = jax.random.key(seed)
    light, albedo = jax_lighting_draws(key)
    lk, ak = jax.random.split(key)
    want = jrender.sample_lighting(lk)
    got = trender.sample_lighting(*light)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    pos = np.random.default_rng(seed).uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
    np.testing.assert_allclose(trender.procedural_albedo(t(pos), albedo).numpy(),
                               np.asarray(jrender.procedural_albedo(jnp.asarray(pos), ak)), atol=1e-6)
    for g, w in zip(trender.default_lighting("cpu"), jrender.default_lighting()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def _scene(category, seed, hw=(64, 80)):
    rng = np.random.default_rng(seed)
    mesh = jshapes.make_category_mesh(category, rng)
    r = special_ortho_group.rvs(3, random_state=rng).astype(np.float32)
    tr = np.array([rng.uniform(-0.03, 0.03), rng.uniform(-0.03, 0.03), rng.uniform(0.6, 0.9)], np.float32)
    k = jrender.NOCS_INTRINSICS.copy()
    k[0] *= hw[1] / 640
    k[1] *= hw[0] / 480
    return mesh, rng, r, tr, np.float32(rng.uniform(0.15, 0.3)), k


def _assert_renders_close(got, want):
    (gd, gg), (wd, wg) = (x.numpy() for x in got), (np.asarray(x) for x in want)
    both = (gd > 0) & (wd > 0)
    assert np.mean((gd > 0) == (wd > 0)) >= 0.999 and both.sum() > 100
    np.testing.assert_allclose(gd[both], wd[both], atol=1e-5)
    np.testing.assert_allclose(gg[both], wg[both], atol=1e-5)


@pytest.mark.parametrize("category,seed,textured", [("mug", 0, True), ("camera", 1, True),
                                                     ("bowl", 2, False)])
def test_splat_render_matches_jax(category, seed, textured):
    """64x80, 20,000 samples, the reference's lighting and texture draws (or
    its default lighting): coverage equal on at least 99.9% of pixels, depth
    within 1e-5 m and gray within 1e-5 where both cover."""
    mesh, rng, r, tr, s, k = _scene(category, seed)
    samples, normals = jshapes.sample_surface(mesh, 20000, rng)
    key = jax.random.key(seed)
    lk, ak = jax.random.split(key)
    light, albedo = jax_lighting_draws(key)
    jkw, tkw = {}, {}
    if textured:
        jkw = dict(lighting=jrender.sample_lighting(lk),
                   albedo=jrender.procedural_albedo(jnp.asarray(samples), ak))
        tkw = dict(lighting=trender.sample_lighting(*light),
                   albedo=trender.procedural_albedo(t(samples), albedo))
    render = jax.jit(jrender.splat_render_depth, static_argnames=("height", "width"))
    want = render(jnp.asarray(samples), jnp.asarray(normals), jnp.asarray(r), jnp.asarray(tr), s,
                  jnp.asarray(k), height=64, width=80, **jkw)
    got = trender.splat_render_depth(t(samples), t(normals), t(r), t(tr), float(s), t(k), 64, 80, **tkw)
    _assert_renders_close(got, want)


@pytest.mark.parametrize("category,seed", [("mug", 3), ("laptop", 4)])
def test_raster_render_matches_jax(category, seed):
    """The subdivided, padded mesh through the fragment grid in 2,048-face
    blocks with the reference's lighting and per-fragment texture: coverage
    equal on at least 99.9% of pixels, depth within 1e-5 m and gray within
    1e-5 where both cover."""
    mesh, _, r, tr, s, k = _scene(category, seed)
    verts, faces = jsynth._pad_mesh(*jshapes.subdivide_mesh(mesh, 1 / 48))
    tv, tf = tsynth._pad_mesh(*tshapes.subdivide_mesh(mesh, 1 / 48))
    np.testing.assert_array_equal(tv, verts)
    np.testing.assert_array_equal(tf, faces)
    key = jax.random.key(seed)
    lk, ak = jax.random.split(key)
    light, albedo = jax_lighting_draws(key)
    render = jax.jit(jrender.raster_render_depth, static_argnames=("height", "width", "face_chunk"))
    want = render(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(r), jnp.asarray(tr), s, jnp.asarray(k),
                  height=64, width=80, lighting=jrender.sample_lighting(lk), albedo_key=ak, face_chunk=2048)
    got = trender.raster_render_depth(t(verts), t(faces), t(r), t(tr), float(s), t(k), 64, 80,
                                      lighting=trender.sample_lighting(*light), albedo=albedo,
                                      face_chunk=2048)
    _assert_renders_close(got, want)


# ---------------------------------------------------------------------------
# the frame tail and the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("category,seed", [("mug", 5), ("can", 6)])
def test_frame_tail_on_jax_render(category, seed):
    """The JAX package renders a 96x128 frame (n_max 512, shot_k 24, the
    frontend test's sizes); the port's tail runs on that render with the same
    voxel draws. Downsample picks, validity, count and pixels exact;
    pc_canon, rotation, translation, bound within 1e-5.

    Normals, compared up to sign: 99% within 1e-5 (the frontend test's
    quantile). Each of the others is a smallest eigenvector that rounding
    moves by about ulp / gap, so every row's error times its covariance's
    relative eigengap stays within 1e-5 (measured up to 3.7e-6 over ten
    frames of five categories; the worst row, 0.106 off on "can" seed 6,
    has a gap of 3.45e-5, which is why the frontend's 0.05 cap cannot hold
    here). A sign differs only where the normal is edge-on to the view ray
    (|n . ray| < 1e-4), as the flip toward the viewpoint then rests on the
    last ulp.

    SHOT rows: 85% within 1e-4 (the frontend test's quantile), and every row
    whose local frame (each package's `shot_lrf` on the same cloud) agrees
    within 1e-5 and whose neighborhood's normals agree within 1e-5 is within
    1e-4 (measured 1.2e-5 at worst). The rows left out are those whose
    frame's axis signs a near-tied vote decides (at most 27 of 512 over the
    ten frames); they read up to 0.65 off, a reflected histogram, which is
    why the frontend's 0.2 cap cannot hold here."""
    mesh, rng, r, tr, s, k = _scene(category, seed, hw=(96, 128))
    samples, normals = jshapes.sample_surface(mesh, 20000, rng)
    bound_canon = (mesh[0].max(0) - mesh[0].min(0)).astype(np.float32)
    key, light_key = jax.random.key(seed), jax.random.key(seed + 100)
    frame = jsynth._device_frame(jnp.asarray(samples), jnp.asarray(normals), jnp.asarray(r), jnp.asarray(tr),
                                 s, jnp.asarray(bound_canon), jnp.asarray(k), float(JCATS[category].res), key,
                                 n_max=512, height=96, width=128, shot_k=24, light_key=light_key,
                                 texture=True)
    draws = jax_frame_draws(seed, None, 96 * 128, True, "cpu")
    got = tsynth._frame_from_render(t(frame.depth), t(frame.gray), t(r), t(tr), float(s), t(bound_canon),
                                    t(k), float(TCATS[category].res), draws, 512, 24)
    assert int(got.count) == int(frame.count) and int(got.count) > 300
    for name in ("pc", "valid", "pixel_yx", "depth", "gray"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(frame, name)), name)
    for name in ("pc_canon", "rotation", "translation", "bound", "scale_norm"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(frame, name)), atol=1e-5,
                                   err_msg=name)
    v = np.asarray(frame.valid)
    radius = float(TCATS[category].res) * 10
    nbrs = tneighbors.knn_radius_neighbors(got.pc, got.valid, radius, 24)
    n, m = got.normal.numpy(), np.asarray(frame.normal)
    err_raw = np.abs(n - m).max(-1)
    err_n = np.minimum(err_raw, np.abs(n + m).max(-1))
    assert np.quantile(err_n[v], 0.99) < 1e-5
    assert np.all((err_n * _relative_eigengap(nbrs))[v] <= 1e-5)
    pc = got.pc.numpy()
    edge_on = np.abs(np.sum(n * pc, -1)) / np.maximum(np.linalg.norm(pc, axis=-1), 1e-9)
    flipped = v & (err_raw > 1e-5) & (err_n <= 1e-5)
    assert np.all(edge_on[flipped] < 1e-4)

    err_s = np.abs(got.shot.numpy() - np.asarray(frame.shot)).max(-1)
    assert np.quantile(err_s[v], 0.85) < 1e-4
    lrf_t = tshot.shot_lrf(got.pc, nbrs, radius).numpy()
    lrf_j = np.asarray(jax.jit(lambda p, ok: jshot.shot_lrf(p, jneighbors.knn_radius_neighbors(
        p, ok, radius, 24), radius))(frame.pc, frame.valid))
    idx, nb_ok = nbrs.idx.numpy(), nbrs.valid.numpy()
    hood = np.maximum(err_raw, np.where(nb_ok, err_raw[idx], 0.0).max(-1))
    calm = v & (np.abs(lrf_t - lrf_j).reshape(-1, 9).max(-1) < 1e-5) & (hood < 1e-5)
    assert calm.sum() >= 0.9 * v.sum() and np.all(err_s[calm] < 1e-4)


def _relative_eigengap(nbrs):
    """(lambda_2 - lambda_1) / lambda_3 of each point's neighbor covariance
    (eigenvalues ascending, float64), the covariance `estimate_normals` takes
    its smallest eigenvector of."""
    rel, w = nbrs.rel.double().numpy(), nbrs.valid.double().numpy()
    mean = np.sum(rel * w[..., None], 1) / np.maximum(w.sum(-1, keepdims=True), 1.0)
    d = (rel - mean[:, None]) * w[..., None]
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", d, d))
    return (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, 2], 1e-300)


def _generators(category, seed, **kw):
    kw = {**SMALL, "height": 64, "width": 80, **kw}
    return (jsynth.SyntheticFrameGenerator(JCATS[category], seed=seed, **kw),
            tsynth.SyntheticFrameGenerator(TCATS[category], seed=seed, device="cpu",
                                           draw_fn=jax_frame_draws, **kw))


def _assert_frames_agree(got, want):
    """The same picks: validity, count, pixels and bound exact; the cloud,
    the canonical cloud and the pose within 1e-5 (the raster pass's depths
    differ in the last ulps, and the cloud with them)."""
    assert int(got.count) == int(want.count)
    for name in ("valid", "pixel_yx", "bound"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    for name in ("pc", "pc_canon", "rotation", "translation"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("category,seed,kw,handles", [
    ("bottle", 1, {}, None),                                    # up-symmetric: map_sym
    ("mug", 2, {}, [1, 1, 0]),                                  # handle seen, then hidden
    ("mug", 2, dict(require_handle_visible=True), [1, 1, 1]),   # the hidden one redrawn
    ("laptop", 1, {}, None),
    ("camera", 1, dict(full_rot=True), None),                   # special_ortho_group
    ("mug", 0, dict(renderer="raster", z_range=(0.5, 0.8)), None),
])
def test_next_frame_matches_jax(category, seed, kw, handles):
    """Three frames of each generator on the reference's draws: each frame as
    `_assert_frames_agree` says, the handle flag equal (and as listed), and
    the numpy stream in the same state after every frame, retries included."""
    jgen, tgen = _generators(category, seed, **kw)
    flags = []
    for _ in range(3):
        want, got = jgen.next_frame(), tgen.next_frame()
        _assert_frames_agree(got, want)
        assert tgen.last_handle_visible == jgen.last_handle_visible
        assert tgen.last_meta == jgen.last_meta
        assert tgen.rng.bit_generator.state == jgen.rng.bit_generator.state
        flags.append(tgen.last_handle_visible)
    if handles is not None:
        assert flags == handles


def test_fixed_mesh_is_subdivided_once(monkeypatch):
    """A caller's fixed mesh through the raster renderer: subdivided once for
    the frames that reuse it, again after its vertices move in place; the
    frames agree with the reference's."""
    mesh = tshapes.make_category_mesh("can", np.random.default_rng(9))
    jgen, tgen = _generators("can", 3, renderer="raster", z_range=(0.5, 0.8))
    calls = []
    real = tsynth.subdivide_mesh
    monkeypatch.setattr(tsynth, "subdivide_mesh", lambda *a, **k: calls.append(1) or real(*a, **k))
    for step in range(3):
        if step == 2:
            mesh[0][:] += 0.01
        _assert_frames_agree(tgen.next_frame(mesh), jgen.next_frame(mesh))
    assert len(calls) == 2
    assert tgen.rng.bit_generator.state == jgen.rng.bit_generator.state


def test_batch_and_default_draws():
    """`batch` against the reference's: the same keys, shapes and dtypes, the
    same clouds and counts. The default draws are seeded: the same seeds give
    the same numbers, a voxel permutation is one."""
    jgen, tgen = _generators("bowl", 4)
    want, got = jgen.batch(2), tgen.batch(2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in ("pc", "count", "bound"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["pc_canon"], want["pc_canon"], atol=1e-5)
    a = tsynth.threefry_draws(5, 6, 100, True, "cpu")
    b = tsynth.threefry_draws(5, 6, 100, True, "cpu")
    for x, y in zip([a.perm, a.prio, *a.lighting, *a.albedo], [b.perm, b.prio, *b.lighting, *b.albedo]):
        assert torch.equal(x, y)
    assert torch.equal(torch.sort(a.perm).values, torch.arange(100))
    assert a.albedo.directions.shape == (4, 3)
    assert tsynth.threefry_draws(5, None, 100, True, "cpu").lighting is None
    assert tsynth.threefry_draws(5, 6, 100, False, "cpu").albedo is None


def test_dump_rendered_frames_read_by_jax(tmp_path):
    """`dump_frames` of rendered frames (tensors on the frame's device):
    the JAX package's RecordReader reads back every field."""
    gen = tsynth.SyntheticFrameGenerator(TCATS["mug"], seed=1, height=64, width=80, device="cpu", **SMALL)
    frames = [gen.next_frame() for _ in range(3)]
    dump_frames(str(tmp_path / "r.rec"), frames, n_points=128)
    reader = JRecordReader(str(tmp_path / "r.rec"))
    assert len(reader) == 3
    got = reader.batch([0, 1, 2])
    for name in ("pc", "pc_canon", "shot", "normal", "bound", "count"):
        want = np.stack([tsynth.to_host(f, (name,))[name] for f in frames])
        np.testing.assert_array_equal(got[name], want.astype(got[name].dtype), name)
