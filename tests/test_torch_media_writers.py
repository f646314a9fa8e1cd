"""The port's media writers against the JAX package's, on the CPU:
`save_videos_grid` and `save_videos_comparison` (the arrays each hands to
`save_video`, captured), `merge_video_audio` (no ffmpeg on PATH, and a stub
ffmpeg that records its arguments), and the OpenCV steps rebuilt in numpy
held to OpenCV (`cv2.resize` of float frames; `cv2.cvtColor` RGB <-> LAB of
uint8, within one level; `color_transfer` end to end)."""

import os
import stat
import sys

import numpy as np
import pytest

from flexam_tpu.utils import media as jmedia
from flexam_tpu_torch.utils import media as tmedia


@pytest.fixture
def captured(monkeypatch):
    """{package: [(video, path, fps), ...]} for every save_video call."""
    out = {"jax": [], "port": []}
    for name, mod in (("jax", jmedia), ("port", tmedia)):
        monkeypatch.setattr(mod, "save_video",
                            lambda v, p, fps=16, _n=name:
                            out[_n].append((np.array(v), p, fps)) or p)
    return out


@pytest.mark.parametrize("b,n_rows,rescale", [(1, 6, False), (5, 2, True),
                                              (7, 3, False)])
def test_save_videos_grid_matches_jax(captured, b, n_rows, rescale):
    v = np.random.RandomState(b).rand(b, 3, 4, 6, 5).astype(np.float32)
    for mod in (jmedia, tmedia):
        mod.save_videos_grid(v, "grid.mp4", n_rows=n_rows, fps=8,
                             rescale=rescale)
    (jv, jp, jf), = captured["jax"]
    (tv, tp, tf), = captured["port"]
    assert (tp, tf) == (jp, jf)
    assert tv.dtype == jv.dtype
    np.testing.assert_array_equal(tv, jv)


def test_save_videos_comparison_matches_jax(captured):
    """Clips cut to the shortest and resized to the tallest: the port's
    numpy bilinear against JAX's `cv2.resize` within float32 rounding."""
    pytest.importorskip("cv2")
    rs = np.random.RandomState(1)
    vids = [rs.rand(1, 3, 7, 32, 48).astype(np.float32),
            rs.rand(1, 3, 9, 20, 30).astype(np.float32),
            rs.rand(1, 3, 8, 32, 40).astype(np.float32),
            rs.rand(1, 3, 7, 13, 17).astype(np.float32)]
    for mod in (jmedia, tmedia):
        mod.save_videos_comparison(vids, "cmp.mp4", fps=12)
    (jv, jp, jf), = captured["jax"]
    (tv, tp, tf), = captured["port"]
    assert (tp, tf) == (jp, jf) and tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(40, 60), (10, 17), (33, 49), (20, 30)])
def test_resize_frames_linear_matches_cv2(size):
    cv2 = pytest.importorskip("cv2")
    frames = np.random.RandomState(2).rand(3, 20, 30, 3).astype(np.float32)
    h, w = size
    ref = np.stack([cv2.resize(f, (w, h)) for f in frames])
    got = tmedia.resize_frames_linear(frames, size)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _cube(step=3):
    r = np.arange(0, 256, step)
    c = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
    return c.reshape(-1, 1, 3).astype(np.uint8)


def test_rgb_lab_match_cv2():
    """Every third level of each channel (86^3 colours), both ways: within
    one level of OpenCV (its fixed point differs by one in a or b on a
    thousandth of a percent of the colours, LAB -> RGB on none)."""
    cv2 = pytest.importorskip("cv2")
    cube = _cube()
    for ours, code in ((tmedia.rgb_to_lab_u8, cv2.COLOR_RGB2LAB),
                       (tmedia.lab_to_rgb_u8, cv2.COLOR_LAB2RGB)):
        got = ours(cube)
        assert got.dtype == np.uint8 and got.shape == cube.shape
        diff = np.abs(got.astype(np.int16) - cv2.cvtColor(cube, code))
        assert diff.max() <= 1, (code, diff.max())


def test_color_transfer_matches_jax():
    """`color_transfer` against JAX's (OpenCV's conversions). The bound is
    two levels on at most 0.1 % of the values: an RGB -> LAB value one
    level off moves the LAB statistics by a hair, which can tip the uint8
    truncation of a transferred LAB value by one level, and one LAB level
    is up to two RGB levels through the conversion's slope."""
    pytest.importorskip("cv2")
    rs = np.random.RandomState(0)
    diffs = []
    for k in range(12):
        src = rs.randint(0, 256, (24, 32, 3)).astype(np.uint8)
        if k % 2:
            src = (src // 4 + rs.randint(0, 192)).astype(np.uint8)
        tgt = (rs.rand(24, 32, 3) * rs.rand(3) * 255).astype(np.uint8)
        got = tmedia.color_transfer(src, tgt)
        ref = jmedia.color_transfer(src, tgt)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        diffs.append(np.abs(got.astype(np.int16) - ref))
    d = np.stack(diffs)
    assert d.max() <= 2 and (d > 0).mean() <= 1e-3, (d.max(),
                                                     (d > 0).mean())


def _stub_ffmpeg(bin_dir, log):
    """An `ffmpeg` on PATH that appends its arguments to `log`."""
    bin_dir.mkdir(exist_ok=True)
    exe = bin_dir / "ffmpeg"
    exe.write_text(f"#!{sys.executable}\nimport sys, json\n"
                   f"open({str(log)!r}, 'a').write("
                   "json.dumps(sys.argv[1:]) + '\\n')\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)


def test_merge_video_audio_without_ffmpeg(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for mod in (jmedia, tmedia):
        assert mod.merge_video_audio("clip.mp4", "a.wav") == "clip.mp4"
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert out[0].startswith("audio mux failed")


def test_merge_video_audio_runs_jax_command(tmp_path, monkeypatch):
    import json
    log = tmp_path / "argv.jsonl"
    _stub_ffmpeg(tmp_path / "bin", log)
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep
                       + os.environ.get("PATH", ""))
    video = str(tmp_path / "clip.mp4")
    results = [mod.merge_video_audio(video, "voice.wav")
               for mod in (jmedia, tmedia)]
    assert results[0] == results[1] == video.replace(".mp4",
                                                     "_with_audio.mp4")
    jargs, targs = (json.loads(line) for line in log.read_text().splitlines())
    assert targs == jargs
    assert targs[:2] == ["-y", "-i"] and "aac" in targs
