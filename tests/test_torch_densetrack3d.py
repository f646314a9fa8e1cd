"""The port's DenseTrack3D (`flexam_tpu_torch/perception/densetrack3d.py`)
against the JAX package's, on the CPU at the tiny geometry of
`tests/test_densetrack3d.py`, with JAX's weights crossed through
`io.convert.from_jax_params` (HWIO kernels to torch's layout), and the
behavioural cases of that file on the port.

Module outputs in fp32 are held at rtol 2e-4 / atol 1e-5; tracks to 1e-3
px with equal visibility (a flip would have to sit on the 0.5 threshold);
the early-exit windows are compared on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.perception import densetrack3d as J
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.perception import densetrack3d as T

TINY = dict(stride=4, window_len=8, model_resolution=(64, 96),
            upsample_factor=4, latent_dim=32, dim=64, num_heads=4,
            num_blocks=2, iters=2, num_virtual_tracks=8, compute="float32")
TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These modules run thousands of small torch ops; beside the other
    test workers, torch's intra-op threads would oversubscribe the cores
    and stall at every op's barrier, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(jmodel, **kw):
    m = T.DenseTrack3D(**{**TINY, **kw}, device="cpu")
    m.params = from_jax_params(_np_tree(jmodel.params), "cpu")
    return m


def _jax_model(params, **kw):
    """A JAX DenseTrack3D holding `params` (JAX's init compiles op by op,
    which takes seconds; the values only need to be the same on both
    sides)."""
    jm = J.DenseTrack3D.__new__(J.DenseTrack3D)
    jm.cfg = J.DenseTrack3DConfig(**{**TINY, **kw})
    jm.params = params
    jm.load_report, jm.load_ok = None, False
    return jm


def _jax_tree(tree):
    """The port's tree in JAX's layout (HWIO kernels)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    a = tree.numpy()
    return jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)


@pytest.fixture(scope="module")
def models():
    seed_model = T.DenseTrack3D(**TINY, seed=5, device="cpu")
    jm = _jax_model(_jax_tree(seed_model.params))
    return jm, _port_model(jm)


def _clip(seed, t=11, h=72, w=104):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, t, 3, h, w).astype(np.float32),
            1.0 + rng.rand(1, t, 1, h, w).astype(np.float32))


def _exits_jax(monkeypatch):
    """Record JAX's early-exit decisions: the last delta of each launch."""
    seen = []
    orig = J._window_iters_jit

    def spy(*a, **k):
        state, last = orig(*a, **k)
        seen.append(float(last))
        return state, last
    monkeypatch.setattr(J, "_window_iters_jit", spy)
    return seen


def test_predictor_matches_jax(models):
    jm, tm = models
    video, depth = _clip(0)
    want = J.DensePredictor3D(jm)(video, depth)
    got = T.DensePredictor3D(tm)(video, depth)
    assert got["dense_reso"] == want["dense_reso"]
    np.testing.assert_allclose(got["trajs_uv"].numpy(),
                               np.asarray(want["trajs_uv"]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["trajs_depth"].numpy(),
                               np.asarray(want["trajs_depth"]), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["vis"].numpy(), np.asarray(want["vis"]),
                               **TOL)
    np.testing.assert_array_equal(got["vis"].numpy() > 0.5,
                                  np.asarray(want["vis"]) > 0.5)
    assert tm.last_info["window_starts"] == [0, 3]


def test_early_exit_cadence_matches_jax(models, monkeypatch):
    """iters 4, checked after every 2. On this clip the windows' checked
    deltas are 0.11647, 0.11497 and 0.11929 (coarse cells), so a tolerance
    of 0.116 lets window 4 exit and keeps windows 0 and 8 (margins of
    4.7e-4 and more, far above float32 rounding); JAX reads the same deltas
    on the host, takes the same decisions, and the tracks agree."""
    jm0, _ = models
    kw = dict(iters=4, iters_per_launch=2, early_exit_tol=0.116)
    jm = _jax_model(jm0.params, **kw)
    tm = _port_model(jm, **kw)
    video, depth = _clip(2, t=16, h=64, w=96)
    seen = _exits_jax(monkeypatch)
    want = J.DensePredictor3D(jm)(video, depth)
    got = T.DensePredictor3D(tm)(video, depth)
    info = tm.last_info
    assert info["window_starts"] == [0, 4, 8]
    assert info["early_exit_windows"] == [4]
    assert info["iters"] == [4, 2, 4]
    # JAX's launches: 2 + 1 + 2; the deltas of the first launch of each
    # window are the ones both sides checked
    assert len(seen) == 5
    np.testing.assert_allclose(info["checked_deltas"],
                               [seen[0], seen[2], seen[3]], rtol=1e-4)
    np.testing.assert_allclose(got["trajs_uv"].numpy(),
                               np.asarray(want["trajs_uv"]), rtol=0,
                               atol=1e-3)


def test_building_blocks_match_jax(models):
    """The encoder (stride-2 SAME pads), the correlation volumes and their
    sampling, the update transformer (tanh GELU, exact attention) and the
    convex upsampler, one by one."""
    jm, tm = models
    cfg = tm.cfg
    rng = np.random.RandomState(2)
    frames = rng.randn(3, 64, 96, 3).astype(np.float32)
    fj = jax.jit(J.encode_frames)(jm.params["encoder"], jnp.asarray(frames))
    ft = T.encode_frames(tm.params["encoder"], torch.from_numpy(frames),
                         chunk=2)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=2e-4,
                               atol=1e-4)
    vj = jax.jit(J.build_corr_volumes, static_argnums=2)(fj[0], fj, jm.cfg)
    vt = T.build_corr_volumes(torch.from_numpy(np.asarray(fj[0])),
                              torch.from_numpy(np.asarray(fj)), cfg)
    for a, b in zip(vt, vj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-4)
    h, w = cfg.grid_hw
    disp = rng.uniform(-9, 9, (3, h, w, 2)).astype(np.float32)
    np.testing.assert_allclose(
        T.sample_corr(vt, torch.from_numpy(disp), cfg).numpy(),
        np.asarray(jax.jit(J.sample_corr, static_argnums=2)(
            vj, jnp.asarray(disp), jm.cfg)), rtol=2e-4,
        atol=1e-4)
    tokens = rng.randn(cfg.window_len, 30, cfg.token_dim).astype(np.float32)
    np.testing.assert_allclose(
        T.run_transformer(tm.params["transformer"], torch.from_numpy(tokens),
                          cfg).numpy(),
        np.asarray(jax.jit(J.run_transformer, static_argnums=2)(
            jm.params["transformer"], jnp.asarray(tokens), jm.cfg)),
        rtol=2e-4, atol=1e-4)
    f0 = rng.rand(h, w, cfg.latent_dim).astype(np.float32)
    wj = J.upsample_weights(jm.params["upsampler"], jnp.asarray(f0), jm.cfg)
    wt = T.upsample_weights(tm.params["upsampler"], torch.from_numpy(f0),
                            cfg)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
    field = rng.rand(h, w, 4).astype(np.float32)
    np.testing.assert_allclose(
        T.convex_upsample(torch.from_numpy(field), wt, 4).numpy(),
        np.asarray(J.convex_upsample(jnp.asarray(field), wj, 4)), **TOL)


def _distinct_state_dict(jparams, rng):
    """A torch state dict with distinct values for every leaf of the JAX
    tree, in a scrambled order, convs in torch's OIHW, plus tensors that
    match nothing."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    sd = {}
    for i in rng.permutation(len(flat)):
        arr = rng.randn(*np.asarray(flat[i][1]).shape).astype(np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[f"module_{i}.w"] = torch.from_numpy(np.ascontiguousarray(arr))
    sd["odd_tensor"] = torch.zeros(13, 17)
    sd["step"] = 7                              # not a tensor
    return sd


def test_state_dict_maps_to_the_same_leaves_as_jax(models):
    """Greedy shape matching in JAX's flatten order (sorted dict keys): on
    a state dict of distinct values in scrambled order, every leaf of the
    port receives the tensor JAX's leaf receives, and the reports agree."""
    jm, tm = models
    sd = _distinct_state_dict(jm.params, np.random.RandomState(3))
    jp, jrep = J.map_torch_state_dict(jm.params, {
        k: (v.numpy() if torch.is_tensor(v) else v) for k, v in sd.items()})
    tp, trep = T.map_torch_state_dict(tm.params, sd)
    assert trep == jrep
    assert trep["unused"] == ["odd_tensor"]
    want = from_jax_params(_np_tree(jp), "cpu")
    for (pa, a), (pb, b) in zip(T._jax_leaves(tp), T._jax_leaves(want)):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the port's paths are JAX's keystr paths
    flat, _ = jax.tree_util.tree_flatten_with_path(jm.params)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [
        p for p, _ in T._jax_leaves(tm.params)]


def test_load_jax_format_file_matches_jax(models, tmp_path):
    """A densetrack3d.pth written as `tests/test_densetrack3d.py` writes
    one, loaded by both packages into fresh models: full coverage on both
    sides and the same tracks."""
    jm, _ = models
    flat, _ = jax.tree_util.tree_flatten_with_path(jm.params)
    sd = {}
    for i, (_, leaf) in enumerate(flat):
        arr = np.asarray(leaf)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[f"tensor_{i}"] = torch.from_numpy(np.ascontiguousarray(arr))
    pth = tmp_path / "densetrack3d.pth"
    torch.save({"model": sd}, pth)
    jl = J.load_densetrack3d(str(pth), model=_jax_model(_jax_tree(
        T.DenseTrack3D(**TINY, seed=99, device="cpu").params)))
    tl = T.load_densetrack3d(str(pth), device="cpu", **TINY, seed=99)
    assert jl.load_ok and tl.load_ok
    assert tl.load_report == jl.load_report
    video, depth = _clip(4, t=9, h=64, w=96)
    want = np.asarray(J.DensePredictor3D(jl)(video, depth)["trajs_uv"])
    got = T.DensePredictor3D(tl)(video, depth)["trajs_uv"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_state_dict_roundtrip(models, tmp_path):
    """`DenseTrack3D.state_dict()` saved as a reference-format file loads
    back through the shape mapper exactly."""
    _, tm = models
    pth = tmp_path / "densetrack3d.pth"
    torch.save({"model": tm.state_dict()}, pth)
    fresh = T.DenseTrack3D(**TINY, seed=99, device="cpu")
    video, depth = _clip(6, t=8, h=64, w=96)
    base = T.DensePredictor3D(tm)(video, depth)["trajs_uv"]
    assert not torch.allclose(T.DensePredictor3D(fresh)(video, depth)[
        "trajs_uv"], base)
    loaded = T.load_densetrack3d(str(pth), model=fresh)
    assert loaded.load_ok and not loaded.load_report["missed"]
    torch.testing.assert_close(
        T.DensePredictor3D(loaded)(video, depth)["trajs_uv"], base,
        rtol=0, atol=0)


def test_reference_call_surface(models):
    _, tm = models
    t, h_in, w_in = 11, 72, 104
    video, depth = _clip(0, t, h_in, w_in)
    out = T.DensePredictor3D(tm)(video, depth, grid_query_frame=0)
    hd, wd = out["dense_reso"]
    assert (hd, wd) == (64, 96)
    n = hd * wd
    assert out["trajs_uv"].shape == (1, t, n, 2)
    assert out["vis"].shape == (1, t, n)
    assert out["trajs_depth"].shape == (1, t, n, 1)
    uv = out["trajs_uv"].numpy()
    assert np.isfinite(uv).all()
    assert uv[..., 0].mean() == pytest.approx(w_in / 2, rel=0.35)
    assert uv[..., 1].mean() == pytest.approx(h_in / 2, rel=0.35)
    vis = out["vis"].numpy()
    assert (vis >= 0).all() and (vis <= 1).all()
    assert (out["trajs_depth"].numpy() > 0).all()
    f0 = uv[0, 0].reshape(hd, wd, 2)
    assert abs(f0[0, :, 1].mean() - f0[0, 0, 1]) < 2.0
    with pytest.raises(NotImplementedError):
        T.DensePredictor3D(tm)(video, depth, grid_query_frame=1)


def test_density_downsample_matches_reference_rearrange(models):
    _, tm = models
    video, depth = _clip(1, t=9, h=64, w=96)
    pred = T.DensePredictor3D(tm)
    full = pred(video, depth)
    sub = pred(video, depth, downsample=10)
    hd, wd = full["dense_reso"]
    ref = full["trajs_uv"][0].numpy().reshape(9, hd, wd, 2)
    ref = ref[:, ::10, ::10].reshape(9, -1, 2)
    np.testing.assert_allclose(sub["trajs_uv"][0].numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    assert sub["dense_reso"] == ((hd + 9) // 10, (wd + 9) // 10)


def test_window_starts_and_bilinear_sample():
    cfg = T.DenseTrack3DConfig(window_len=16)
    for t in (16, 17, 24, 40, 97):
        starts = T._window_starts(t, cfg)
        np.testing.assert_array_equal(starts, J._window_starts(t, cfg))
        covered = set()
        for s in starts:
            covered.update(range(s, s + 16))
        assert covered == set(range(t)), t
    assert len(T._window_starts(97, cfg)) == 12      # the flagship clip
    rng = np.random.RandomState(2)
    field = rng.rand(7, 9, 3).astype(np.float32)
    pts = np.stack([rng.uniform(0, 8, 50), rng.uniform(0, 6, 50)],
                   axis=-1).astype(np.float32)
    got = T.bilinear_sample(torch.from_numpy(field), torch.from_numpy(pts))
    want = J.bilinear_sample(jnp.asarray(field), jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_corr_volume_matches_naive():
    cfg = T.DenseTrack3DConfig(**{**TINY, "corr_levels": 2,
                                  "corr_volume_radius": 2, "corr_radius": 1})
    rng = np.random.RandomState(3)
    tw, h, w, c = 3, 8, 12, 5
    f0 = rng.rand(h, w, c).astype(np.float32)
    fmaps = rng.rand(tw, h, w, c).astype(np.float32)
    v0 = T.build_corr_volumes(torch.from_numpy(f0), torch.from_numpy(fmaps),
                              cfg)[0].numpy()
    rv = cfg.corr_volume_radius
    pad = np.pad(fmaps, ((0, 0), (rv, rv), (rv, rv), (0, 0)), mode="edge")
    for t in (0, 2):
        for (y, x) in [(0, 0), (3, 7), (7, 11)]:
            for (sy, sx) in [(-2, -2), (0, 0), (1, -1), (2, 2)]:
                want = f0[y, x] @ pad[t, y + sy + rv, x + sx + rv]
                np.testing.assert_allclose(
                    v0[t, y, x, sy + rv, sx + rv], want / np.sqrt(c),
                    rtol=1e-4)


def test_convex_upsample_invariant(models):
    _, tm = models
    cfg = tm.cfg
    rng = np.random.RandomState(5)
    h, w = cfg.grid_hw
    f0 = torch.from_numpy(rng.rand(h, w, cfg.latent_dim).astype(np.float32))
    wts = T.upsample_weights(tm.params["upsampler"], f0, cfg)
    np.testing.assert_allclose(wts.sum(dim=2).numpy(), 1.0, atol=1e-5)
    field = torch.from_numpy(rng.rand(h, w, 2).astype(np.float32))
    up = T.convex_upsample(field, wts, cfg.upsample_factor)
    assert tuple(up.shape) == (h * 4, w * 4, 2)
    assert float(up.min()) >= float(field.min()) - 1e-5
    assert float(up.max()) <= float(field.max()) + 1e-5


def test_mapper_reports_unmatched(models):
    _, tm = models
    _, report = T.map_torch_state_dict(
        tm.params, {"odd_tensor": np.zeros((13, 17), np.float32)})
    assert "odd_tensor" in report["unused"] and report["missed"]
    with pytest.raises(ValueError):
        T.map_torch_state_dict(tm.params, {"odd_tensor": np.zeros((13, 17))},
                               strict=True)


def test_short_clip_padding_and_delta_wrapper(models):
    """T < window_len pads internally and slices back; the
    generate_tracking_DELTA wrapper returns the rasterizers' [T, N, 3]."""
    jm, tm = models
    video, depth = _clip(7, t=5, h=64, w=96)
    out = T.DensePredictor3D(tm)(video, depth)
    assert out["trajs_uv"].shape[1] == 5
    assert torch.isfinite(out["trajs_uv"]).all()
    from flexam_tpu.perception.tracking import track_video_delta as jtvd
    from flexam_tpu_torch.perception import track_video_delta
    clip = np.random.RandomState(8).rand(9, 40, 56, 3).astype(np.float32)
    tracks, vis = track_video_delta(clip, density=12, model=tm)
    assert tracks.ndim == 3 and tracks.shape[0] == 9 and tracks.shape[2] == 3
    assert vis.shape == tracks.shape[:2] and vis.dtype == bool
    assert (tracks[..., 2] > 0).all()
    want_t, want_v = jtvd(clip, density=12, model=jm)
    np.testing.assert_allclose(tracks[..., :2], want_t[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(tracks[..., 2], want_t[..., 2], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(vis, want_v)
