"""The port's CLIs (`python -m akaze_tpu_torch.cli.{extract,match,sequence,sfm}`)
with --device cpu, mirroring tests/test_cli.py at its sizes and arguments;
their JSON and summary keys against the JAX CLIs' on the same inputs;
feature files that load in either package with equal arrays; and the
stage spans and metrics the CLIs use."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.cli import imgio as jax_imgio
from akaze_tpu.cli import match as jax_cli_match
from akaze_tpu.cli import sequence as jax_cli_sequence
from akaze_tpu.cli import sfm as jax_cli_sfm
from akaze_tpu.sfm.checkpoint import load_checkpoint as jax_load_checkpoint
from akaze_tpu.core import types as jax_types
from akaze_tpu_torch import interop
from akaze_tpu_torch.cli import extract as cli_extract
from akaze_tpu_torch.cli import match as cli_match
from akaze_tpu_torch.cli import sequence as cli_sequence
from akaze_tpu_torch.cli import sfm as cli_sfm
from akaze_tpu_torch.cli.imgio import load_features, load_gray, save_features
from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.pipeline import extract
from akaze_tpu_torch.utils.profiling import MetricsLogger, SpanRecorder, record_spans, span
from akaze_tpu_torch.utils.synthetic import textured_scene, video_sequence, warp_homography

torch.set_num_threads(2)

_FAST = ["--octaves", "3", "--max-keypoints", "128", "--threshold", "1e-4"]
_CPU = [*_FAST, "--device", "cpu"]
_H = np.array([[1.0, 0.01, 3.0], [-0.01, 1.0, -2.0], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    img = textured_scene(120, 160, seed=3)
    a, b = d / "a.npy", d / "b.npy"
    np.save(a, img)
    np.save(b, warp_homography(img, _H))
    return a, b


def test_cli_extract_json_and_npz(image_files, tmp_path):
    a, _ = image_files
    out_json, out_npz = tmp_path / "f.json", tmp_path / "f.npz"
    assert cli_extract.main([str(a), str(out_json), *_CPU]) == 0
    assert cli_extract.main([str(a), str(out_npz), *_CPU]) == 0
    fj, fn = load_features(out_json), load_features(out_npz)
    assert fj["descriptors"].shape == fn["descriptors"].shape and len(fn["descriptors"]) > 20
    assert np.array_equal(fj["descriptors"], fn["descriptors"])
    np.testing.assert_allclose(fj["x"], fn["x"], atol=1e-5)
    assert int(fn["schema_version"]) == int(fj["schema_version"]) == jax_imgio.FEATURE_SCHEMA_VERSION


def _keys(obj):
    """The key structure of the match CLI's JSON."""
    out = {"top": sorted(obj)}
    if obj.get("matches"):
        out["match"] = sorted(obj["matches"][0])
    if "pose" in obj:
        out["pose"] = sorted(obj["pose"])
    return out


def test_cli_match_with_pose_and_keys_equal_jax(image_files, tmp_path):
    a, b = image_files
    out, viz = tmp_path / "m.json", tmp_path / "viz.pgm"
    assert cli_match.main([str(a), str(b), "--pose", "-o", str(out), "--viz", str(viz), *_CPU]) == 0
    m = json.loads(out.read_text())
    assert m["num_matches"] > 5 and m["num_matches"] == len(m["matches"])
    assert np.asarray(m["pose"]["R"]).shape == (3, 3) and m["pose"]["num_inliers"] > 5
    canvas = load_gray(viz)
    assert canvas.shape == (120, 320) and canvas.max() == 1.0  # side by side, marks drawn
    ref_out = tmp_path / "m_jax.json"
    assert jax_cli_match.main([str(a), str(b), "--pose", "-o", str(ref_out), *_FAST]) == 0
    ref = json.loads(ref_out.read_text())
    assert _keys(m) == _keys(ref)
    assert abs(m["num_matches"] - ref["num_matches"]) <= max(3, 0.1 * ref["num_matches"])


def test_cli_sequence_and_keys_equal_jax(tmp_path):
    frames = video_sequence(6, 96, 128, seed=5)
    fp = tmp_path / "frames.npy"
    np.save(fp, frames)
    out, feats = tmp_path / "seq.json", tmp_path / "feats.npz"
    args = [str(fp), "--batch", "3", "--threshold", "1e-4"]
    assert cli_sequence.main([*args, "-o", str(out), "--features-out", str(feats), *_CPU]) == 0
    s = json.loads(out.read_text())
    assert s["num_frames"] == 6 and len(s["keypoints_per_frame"]) == 6 and s["keyframes"][0] == 0
    ref_out, ref_feats = tmp_path / "seq_jax.json", tmp_path / "feats_jax.npz"
    assert jax_cli_sequence.main([*args, "-o", str(ref_out), "--features-out", str(ref_feats), *_FAST]) == 0
    ref = json.loads(ref_out.read_text())
    assert sorted(s) == sorted(ref)
    with np.load(feats) as z, np.load(ref_feats) as zr:
        assert sorted(z.files) == sorted(zr.files)
        for k in z.files:
            assert z[k].shape == zr[k].shape and z[k].dtype == zr[k].dtype, k


def test_cli_sfm_and_keys_equal_jax(tmp_path, capsys):
    """tests/test_cli.py's SfM smoke run (a planar pan, so structure and
    outputs are checked, not the trajectory): the same JSON keys and track
    count as the JAX CLI, a checkpoint the JAX package loads, and the
    seconds of each stage in its metrics line."""
    fp = tmp_path / "frames.npy"
    np.save(fp, video_sequence(5, 96, 128, seed=5))
    args = [str(fp), "--batch", "5", "--ba-iterations", "4"]
    out, ckpt = tmp_path / "sfm.json", tmp_path / "map.npz"
    assert cli_sfm.main([*args, "-o", str(out), "--checkpoint", str(ckpt), *_CPU]) == 0
    done = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert done["event"] == "sfm_done" and {"process_video", "tracks", "sfm"} <= set(done["stage_seconds"])
    assert all(t > 0 for t in done["stage_seconds"].values())
    s = json.loads(out.read_text())
    assert s["num_frames"] == 5 and len(s["poses"]) == 5 and s["num_tracks"] > 10
    assert np.isfinite(np.asarray(s["camera_centers"])).all()
    back = jax_load_checkpoint(ckpt)
    assert back.poses.shape == (5, 6) and back.next_keyframe == 5
    ref_out = tmp_path / "sfm_jax.json"
    assert jax_cli_sfm.main([*args, "-o", str(ref_out), *_FAST]) == 0
    ref = json.loads(ref_out.read_text())
    assert sorted(s) == sorted(ref)
    assert s["num_tracks"] == ref["num_tracks"] and s["num_points"] == ref["num_points"]


def test_cli_sfm_refuses_mesh(tmp_path, capsys):
    """A --mesh that differs from the world size (one process here) is refused."""
    with pytest.raises(SystemExit) as e:
        cli_sfm.main([str(tmp_path / "none.npy"), "-o", str(tmp_path / "o.json"), "--mesh", "4", *_CPU])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--mesh 4" in err and "torch.distributed.run --nproc-per-node 4" in err


def test_cli_pgm_end_to_end(tmp_path):
    """The image-file path: a PGM pair through extract -> match --pose --viz;
    the PGM route gives the same features as the same uint8 pixels as .npy."""
    img8 = (textured_scene(120, 160, seed=3) * 255).astype(np.uint8)
    warped8 = (warp_homography(img8.astype(np.float32) / 255.0, _H) * 255).astype(np.uint8)
    paths = {}
    for name, arr in (("a", img8), ("b", warped8)):
        pgm = tmp_path / f"{name}.pgm"
        pgm.write_bytes(f"P5\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode() + arr.tobytes())
        npy = tmp_path / f"{name}.npy"
        np.save(npy, arr)
        paths[name] = (pgm, npy)
        np.testing.assert_array_equal(load_gray(pgm), jax_imgio.load_gray(pgm))
    out_pgm, out_npy = tmp_path / "f_pgm.npz", tmp_path / "f_npy.npz"
    assert cli_extract.main([str(paths["a"][0]), str(out_pgm), *_CPU]) == 0
    assert cli_extract.main([str(paths["a"][1]), str(out_npy), *_CPU]) == 0
    fp, fn = load_features(out_pgm), load_features(out_npy)
    assert fp["descriptors"].shape[0] > 20
    assert np.array_equal(fp["descriptors"], fn["descriptors"])
    np.testing.assert_array_equal(fp["x"], fn["x"])
    out, viz = tmp_path / "m.json", tmp_path / "viz.pgm"
    assert cli_match.main([str(paths["a"][0]), str(paths["b"][0]), "--pose", "-o", str(out), "--viz", str(viz),
                           *_CPU]) == 0
    assert json.loads(out.read_text())["num_matches"] > 5
    assert load_gray(viz).shape == (120, 320)


def test_cli_pgm_loader(tmp_path):
    img = (textured_scene(24, 32, seed=1) * 255).astype(np.uint8)
    p = tmp_path / "img.pgm"
    p.write_bytes(f"P5\n# comment\n{img.shape[1]} {img.shape[0]}\n255\n".encode() + img.tobytes())
    np.testing.assert_allclose(load_gray(p), img.astype(np.float32) / 255.0, atol=1e-6)
    q = tmp_path / "img2.pgm"
    q.write_bytes(f"P2\n{img.shape[1]} {img.shape[0]}\n255\n".encode() + " ".join(map(str, img.ravel())).encode())
    np.testing.assert_array_equal(load_gray(q), jax_imgio.load_gray(q))


def _jax_features(arrays):
    """JAX `Features` holding the same arrays (descriptors as uint32)."""
    kp = jax_types.Keypoints(**{k: jnp.asarray(v) for k, v in arrays.items() if k != "descriptors"})
    return jax_types.Features(keypoints=kp, descriptors=jnp.asarray(arrays["descriptors"]))


@pytest.mark.parametrize("suffix", [".npz", ".json"])
def test_feature_files_load_in_either_package(tmp_path, suffix):
    cfg = AkazeConfig(num_octaves=3, max_keypoints=128, detector_threshold=1e-4)
    feats = extract(textured_scene(120, 160, seed=4), cfg, device="cpu")
    arrays = interop.features_to_numpy(feats)
    assert arrays["valid"].sum() > 20 and not arrays["valid"].all()
    ours, theirs = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    save_features(ours, feats)
    jax_imgio.save_features(theirs, _jax_features(arrays))
    loaded = [load_features(ours), jax_imgio.load_features(ours), load_features(theirs),
              jax_imgio.load_features(theirs)]
    for other in loaded[1:]:
        assert sorted(other) == sorted(loaded[0])
        for k, v in loaded[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
            assert other[k].dtype == v.dtype, k
    v = arrays["valid"]
    np.testing.assert_array_equal(loaded[0]["descriptors"], arrays["descriptors"][v])
    np.testing.assert_array_equal(loaded[0]["x"], arrays["x"][v])


def test_clis_default_to_the_card(image_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    a, b = image_files
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_extract.main([str(a), str(tmp_path / "f.npz"), *_FAST])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_match.main([str(a), str(b), *_FAST])
    np.save(tmp_path / "fr.npy", video_sequence(2, 96, 128, seed=5))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_sequence.main([str(tmp_path / "fr.npy"), "-o", str(tmp_path / "s.json"), *_FAST])


def test_cli_sfm_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    np.save(tmp_path / "fr.npy", video_sequence(2, 96, 128, seed=5))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_sfm.main([str(tmp_path / "fr.npy"), "-o", str(tmp_path / "s.json"), *_FAST])


def test_profiling_utils():
    """The CLIs' stage seconds (the entry spans of one recorder, on the host
    clock off the card) and their JSON-lines metrics."""
    rec = SpanRecorder()
    cpu = torch.device("cpu")
    with record_spans(rec):
        for _ in range(2):
            with span("extract", cpu):
                extract(textured_scene(60, 80, seed=1), device="cpu")
        with pytest.raises(ValueError):  # a failing stage raises through and closes its span
            with span("fails", cpu):
                raise ValueError
    stages = [s.name for s in rec.spans if s.parent is None]
    assert stages == ["extract", "extract", "fails"]
    assert rec.seconds("extract") > rec.seconds("frontend.extract") > 0
    assert {rec.spans[s.parent].name for s in rec.spans if s.name == "frontend.extract"} == {"extract"}
    stream = io.StringIO()
    MetricsLogger(stream).log("sequence_done", frames=3, fps=1.5, stage_seconds={"extract": rec.seconds("extract")})
    line = json.loads(stream.getvalue())
    assert line["event"] == "sequence_done" and line["frames"] == 3 and "time" in line
    assert line["stage_seconds"]["extract"] == rec.seconds("extract")
