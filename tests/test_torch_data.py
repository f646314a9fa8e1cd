"""The port's training-data layer (`flexam_tpu_torch/data/`) against the
JAX package's `flexam_tpu/data/`, mirroring `tests/test_data.py`: the
bucket table and sampler, `DiscreteSampling`'s SP groups, the random
masks, the control dataset's schema, the colour jitter, and the joint
image / video dataset with its type-separated batches.

JAX reads `.mp4` / `.png` through cv2 / PIL; the port reads frame dumps.
So each test writes the media as JAX's test does, decodes the files with
cv2 / PIL, writes the decoded frames as the `.npy` dumps the port reads,
and holds the two samples equal, array for array.
"""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from flexam_tpu import data as J
from flexam_tpu.data import augment as JA
from flexam_tpu.data import dataset as JD
from flexam_tpu_torch import data as T
from flexam_tpu_torch.data import augment as TA
from flexam_tpu_torch.data import dataset as TD


def test_aspect_table_and_bucket_sampler_match_jax():
    assert T.ASPECT_RATIO_512 == J.ASPECT_RATIO_512
    assert T.get_closest_ratio(512, 896) == J.get_closest_ratio(512, 896)
    rs = np.random.RandomState(0)
    sizes = [tuple(int(v) for v in rs.randint(200, 1100, 2))
             for _ in range(40)]
    is_video = list(rs.rand(40) > 0.5)
    for drop_last in (True, False):
        kw = dict(batch_size=3, drop_last=drop_last, seed=5)
        got = list(T.AspectRatioBucketSampler(sizes, is_video, **kw))
        assert got == list(J.AspectRatioBucketSampler(sizes, is_video, **kw))
        for batch in got:
            assert len({is_video[i] for i in batch}) == 1
            assert len({T.get_closest_ratio(*sizes[i])[1]
                        for i in batch}) == 1


def test_discrete_sampling_sp_groups():
    """Ranks of one SP group draw from one sigma interval, the same
    intervals as JAX's (`discrete_sampler.py:5-52`)."""
    world, sp = 8, 4
    for r in range(world):
        kw = dict(uniform_sampling=True, sp_size=sp, world_size=world,
                  rank=r)
        t = T.DiscreteSampling(1000, **kw)
        j = J.DiscreteSampling(1000, **kw)
        assert (t.group_num, t.group_width, t.sigma_interval) == \
            (j.group_num, j.group_width, j.sigma_interval)
        idx = t(256, torch.Generator().manual_seed(r)).numpy()
        jidx = np.asarray(j(256, jax.random.PRNGKey(r)))
        lo = 0 if r < 4 else 500
        for a in (idx, jidx):
            assert a.min() >= lo and a.max() < lo + 500
    plain = T.DiscreteSampling(1000, start_num_idx=10)
    assert plain.bounds() == (10, 1010)


def test_random_masks_match_jax():
    m = TD.get_random_mask((9, 1, 8, 8), np.random.RandomState(0))
    assert m[0].sum() == 0 and (m[1:] == 1).all()
    for seed in range(20):
        for shape in ((9, 1, 8, 8), (1, 1, 8, 8)):
            np.testing.assert_array_equal(
                TD.get_random_mask(shape, np.random.RandomState(seed),
                                   image_start_only=False),
                JD.get_random_mask(shape, np.random.RandomState(seed),
                                   image_start_only=False))


def _dump_video(path):
    """Decode `path` with cv2 (BGR -> RGB, as JAX's reader) and write the
    frames as the `.npy` dump the port reads; returns the dump's name."""
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    out = os.path.splitext(path)[0] + ".npy"
    np.save(out, np.stack(frames))
    return os.path.basename(out)


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif isinstance(w, np.ndarray) or np.isscalar(w):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def test_control_dataset_matches_jax(tmp_path):
    h, w, t = 48, 64, 9
    rs = np.random.RandomState(0)

    def write_video(name, masky=False):
        p = str(tmp_path / name)
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 16, (w, h))
        for i in range(t):
            frame = rs.randint(0, 256, (h, w, 3), np.uint8)
            if masky:
                frame = np.where(frame > 127, 255, 0).astype(np.uint8)
            vw.write(frame)
        vw.release()
        return name

    names = ["v.mp4", "v_control.mp4", "v_depth.mp4"] + [
        f"v_cos_i_{i}.mp4" for i in range(4)] + ["v_mask.mp4"]
    for n in names:
        write_video(n, masky=n == "v_mask.mp4")
    dumps = {n: _dump_video(str(tmp_path / n)) for n in names}

    rows = []
    for gtype in ("full_tracking", "fg_tracking", "bg_tracking"):
        rows.append({
            "file_path": "v.mp4", "control_file_path": "v_control.mp4",
            "depth_file_path": "v_depth.mp4",
            "cos_file_paths": ["v_cos_i_0.mp4"],
            "mask_file_path": "v_mask.mp4",
            "density": 10, "text": "a test video", "generate_type": gtype})

    def port_row(r):
        out = dict(r)
        for k in ("file_path", "control_file_path", "depth_file_path",
                  "mask_file_path"):
            out[k] = dumps[r[k]]
        out["cos_file_paths"] = [dumps[p] for p in r["cos_file_paths"]]
        return out

    (tmp_path / "ann.json").write_text(json.dumps(rows))
    (tmp_path / "ann_port.json").write_text(
        json.dumps([port_row(r) for r in rows]))
    kw = dict(video_sample_size=(32, 40), video_sample_n_frames=7)
    jds = JD.ImageVideoControlDataset(str(tmp_path / "ann.json"), **kw)
    tds = TD.ImageVideoControlDataset(str(tmp_path / "ann_port.json"), **kw)
    for i in range(3):
        s = tds[i]
        _assert_samples_equal(s, jds[i])
        assert s["pixel_values"].shape == (3, 7, 32, 40)
        assert len(s["cos_pixel_values_list"]) == 4
        assert s["density"] == pytest.approx(0.1)
        assert s["mask"].shape == (1, 7, 32, 40) and s["mask"][:, 0].sum() == 0


def test_bad_sample_resamples_as_jax(tmp_path, capsys):
    """A row whose file the port has no decoder for (.mp4) fails and is
    replaced by a random row drawn from the dataset's own rng."""
    np.save(tmp_path / "ok.npy", np.zeros((3, 8, 8, 3), np.uint8))
    rows = [{"file_path": "bad.mp4", "control_file_path": "bad.mp4",
             "text": "bad"},
            {"file_path": "ok.npy", "control_file_path": "ok.npy",
             "text": "ok"}]
    (tmp_path / "ann.json").write_text(json.dumps(rows))
    ds = TD.ImageVideoControlDataset(str(tmp_path / "ann.json"),
                                     video_sample_size=(8, 8),
                                     video_sample_n_frames=3,
                                     enable_inpaint=False, seed=1)
    assert ds[0]["text"] == "ok"
    assert "resampling" in capsys.readouterr().out


def test_color_jitter_matches_jax():
    rng = np.random.RandomState(0)
    video = rng.randint(0, 256, (3, 24, 45, 3), np.uint8)
    for name, factor in [("adjust_brightness", 1.3),
                         ("adjust_contrast", 0.7),
                         ("adjust_saturation", 1.4),
                         ("adjust_hue", 0.07), ("adjust_hue", -0.09)]:
        np.testing.assert_array_equal(getattr(TA, name)(video, factor),
                                      getattr(JA, name)(video, factor),
                                      err_msg=name)
    np.testing.assert_array_equal(
        TA.video_color_jitter(video, rng=np.random.RandomState(2)),
        JA.video_color_jitter(video, rng=np.random.RandomState(2)))
    same = np.repeat(video[:1], 4, axis=0)
    out = TA.video_color_jitter(same, rng=np.random.RandomState(3))
    for f in range(1, 4):
        np.testing.assert_array_equal(out[f], out[0])


def test_image_video_dataset_and_type_batches_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    rows, port_rows = [], []
    for i in range(2):
        img = rng.randint(0, 255, (20, 22, 3), np.uint8)
        Image.fromarray(img).save(str(tmp_path / f"img{i}.png"))
        np.save(tmp_path / f"img{i}.npy",
                np.asarray(Image.open(str(tmp_path / f"img{i}.png"))
                           .convert("RGB")))
        rows.append({"file_path": f"img{i}.png", "text": f"img {i}",
                     "type": "image"})
        port_rows.append(dict(rows[-1], file_path=f"img{i}.npy"))
    for i in range(2):
        p = str(tmp_path / f"vid{i}.mp4")
        wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 8,
                             (32, 32))
        for _ in range(9):
            wr.write(rng.randint(0, 255, (32, 32, 3), np.uint8))
        wr.release()
        rows.append({"file_path": os.path.basename(p), "text": f"vid {i}",
                     "type": "video"})
        port_rows.append(dict(rows[-1], file_path=_dump_video(p)))
    (tmp_path / "ann.json").write_text(json.dumps(rows))
    (tmp_path / "ann_port.json").write_text(json.dumps(port_rows))

    kw = dict(image_sample_size=(16, 18), video_sample_size=(24, 32),
              video_sample_n_frames=9, enable_jitter=True)
    jds = JD.ImageVideoDataset(str(tmp_path / "ann.json"), **kw)
    tds = TD.ImageVideoDataset(str(tmp_path / "ann_port.json"), **kw)
    for i in range(4):
        _assert_samples_equal(tds[i], jds[i])
    assert tds[0]["pixel_values"].shape == (3, 1, 16, 18)
    assert tds[2]["pixel_values"].shape == (3, 9, 24, 32)
    got = list(TD.type_separated_batches(tds, 2, np.random.RandomState(3)))
    assert got == list(JD.type_separated_batches(jds, 2,
                                                 np.random.RandomState(3)))
    for batch in got:
        assert len({tds.sample_type(i) for i in batch}) == 1
