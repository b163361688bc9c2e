"""The whole slice of the PyTorch port (batched extract + consecutive match)
against the JAX package on the CPU, plus the port's contracts: interop
round trips, copied tables equal to the JAX ones, TF32 off, CUDA by
default, integer input normalisation, and no JAX imports."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core import fed as jax_fed
from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import Diffusivity as JaxDiffusivity
from akaze_tpu.core.config import MatchConfig as JaxMatchConfig
from akaze_tpu.frontend.pipeline import _statics as jax_statics
from akaze_tpu.frontend.pipeline import extract_batch_fn
from akaze_tpu.golden import image as golden_image
from akaze_tpu.matching.hamming import match_fn as jax_match_fn
from akaze_tpu.utils import synthetic as jax_synthetic
from akaze_tpu_torch import interop
from akaze_tpu_torch.core import fed, image
from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig
from akaze_tpu_torch.frontend.pipeline import _statics, extract, extract_batch
from akaze_tpu_torch.matching.hamming import match, match_features
from akaze_tpu_torch.utils import synthetic
from torch_port_helpers import pair_keypoints

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H, W = 240, 320


@pytest.fixture(scope="module")
def slice_outputs():
    frames = jax_synthetic.video_sequence(3, H, W, seed=3)
    jf = jax.jit(lambda im: extract_batch_fn(im, JaxAkazeConfig()))(jnp.asarray(frames))
    jm = jax.vmap(lambda *x: jax_match_fn(*x, JaxMatchConfig()))(
        jf.descriptors[:-1], jf.keypoints.valid[:-1], jf.descriptors[1:], jf.keypoints.valid[1:]
    )
    tf = extract_batch(frames, device="cpu")
    tm = match(tf.descriptors[:-1], tf.keypoints.valid[:-1], tf.descriptors[1:], tf.keypoints.valid[1:],
               device="cpu")
    jnp_feats = {f.name: np.asarray(getattr(jf.keypoints, f.name)) for f in dataclasses.fields(jf.keypoints)}
    jnp_feats["descriptors"] = np.asarray(jf.descriptors)
    return frames, jnp_feats, np.asarray(jm.accepted), tf, tm


def test_slice_matches_jax(slice_outputs):
    _, ref, ref_acc, tf, tm = slice_outputs
    got = interop.features_to_numpy(tf)
    assert got["descriptors"].shape == (3, 1024, 16) and got["descriptors"].dtype == np.uint32
    for b in range(3):
        n_ref, n_got = int(ref["valid"][b].sum()), int(got["valid"][b].sum())
        assert n_ref > 50
        assert abs(n_ref - n_got) <= max(2, 0.02 * n_ref)
        frac, hams = pair_keypoints({k: v[b] for k, v in ref.items()}, {k: v[b] for k, v in got.items()})
        assert frac >= 0.98
        assert hams.mean() <= 3.0
    acc_ref, acc_got = ref_acc.sum(axis=1), tm.count().numpy()
    assert (acc_ref > 20).all()
    assert (np.abs(acc_ref - acc_got) <= 0.05 * acc_ref).all()


def test_interop_round_trips(slice_outputs):
    _, ref, _, tf, _ = slice_outputs
    back = interop.features_from_numpy(interop.features_to_numpy(tf))
    for f in dataclasses.fields(tf.keypoints):
        assert torch.equal(getattr(back.keypoints, f.name), getattr(tf.keypoints, f.name))
    assert torch.equal(back.descriptors, tf.descriptors)
    # JAX features cross as numpy: the uint32 words keep their bits.
    again = interop.features_to_numpy(interop.features_from_numpy(ref))
    for k, v in ref.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)

    jcfg = JaxAkazeConfig(diffusivity=JaxDiffusivity.WEICKERT, max_keypoints=512, num_octaves=3)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    assert cfg == AkazeConfig(diffusivity=Diffusivity.WEICKERT, max_keypoints=512, num_octaves=3)
    mcfg = interop.config_from_fields(dataclasses.asdict(JaxMatchConfig(ratio=0.7, mutual=False)))
    assert mcfg == MatchConfig(ratio=0.7, mutual=False)
    assert dataclasses.asdict(AkazeConfig()) == {
        k: (v.value if isinstance(v, JaxDiffusivity) else v)
        for k, v in dataclasses.asdict(JaxAkazeConfig()).items()
    } | {"diffusivity": Diffusivity.PM_G2}


def test_copied_tables_equal_jax():
    for (w, h) in ((640, 480), (320, 240), (50, 30)):
        cfg, jcfg = AkazeConfig(), JaxAkazeConfig()
        got, want = fed.allocate_evolutions(w, h, cfg), jax_fed.allocate_evolutions(w, h, jcfg)
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    specs = fed.allocate_evolutions(640, 480, AkazeConfig())
    assert len(specs) == 16 and sum(len(s.taus) for s in specs) == 166
    for sigma in (1.0, 1.6, 2.5):
        np.testing.assert_array_equal(image.gaussian_kernel(sigma), golden_image.gaussian_kernel(sigma))
    for s in (1, 2, 3, 4):
        for a, b in zip(image.scharr_kernels(s), golden_image.scharr_kernels(s)):
            np.testing.assert_array_equal(a, b)
    ss, ds = _statics(640, 480, AkazeConfig())
    jss, jds = jax_statics(640, 480, JaxAkazeConfig())
    for name in ("widths", "heights", "octaves", "ratios", "esigmas", "sigma_sizes", "borders", "sizes"):
        np.testing.assert_array_equal(getattr(ss, name), getattr(jss, name), err_msg=name)
    for name in ("ori_di", "ori_dj", "ori_w", "win_lo", "win_hi", "win_wrap", "all_offk", "all_offl"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name), err_msg=name)
    assert (len(ds.ori_di), len(ds.win_lo), ds.n_samples, ds.total_bits) == (109, 42, 441, 486)
    for g, jg in zip(ds.grids, jds.grids):
        for key in ("mean_mat", "pa", "pb"):
            np.testing.assert_array_equal(g[key], jg[key])
    np.testing.assert_array_equal(synthetic.video_sequence(2, 120, 160, seed=5),
                                  jax_synthetic.video_sequence(2, 120, 160, seed=5))


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    frames = synthetic.video_sequence(2, 120, 160, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_batch(frames)
    with pytest.raises(RuntimeError, match="CUDA"):
        match(np.zeros((8, 16), np.uint32), np.ones(8, bool), np.zeros((8, 16), np.uint32), np.ones(8, bool))
    # CPU tensors do not choose the device either: only device="cpu" does.
    d, v = torch.zeros((8, 16), dtype=torch.int32), torch.ones(8, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        match(d, v, d, v)
    feats = extract_batch(frames, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        match_features(feats.index(0), feats.index(1))
    assert match_features(feats.index(0), feats.index(1), device="cpu").accepted.shape == (1024,)
    with pytest.raises(ValueError):
        extract_batch(frames[0], device="cpu")
    with pytest.raises(ValueError):
        extract(frames, device="cpu")


def test_uint8_input_equals_float_over_255():
    u8 = (synthetic.video_sequence(2, 120, 160, seed=2) * 255).astype(np.uint8)
    a = extract_batch(u8, device="cpu")
    b = extract_batch(u8.astype(np.float32) / 255, device="cpu")
    assert a.keypoints.valid.sum() > 10
    assert torch.equal(a.descriptors, b.descriptors)
    for f in dataclasses.fields(a.keypoints):
        assert torch.equal(getattr(a.keypoints, f.name), getattr(b.keypoints, f.name))
    one = extract(u8[1], device="cpu")
    assert torch.equal(one.descriptors, a.descriptors[1])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "akaze_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "akaze_tpu"), f"{path.name} imports {name}"


def test_flat_frame_has_no_keypoints():
    """A flat frame gives no keypoints, all-zero descriptors and no match;
    its textured neighbour equals JAX."""
    frames = synthetic.video_sequence(2, 120, 160, seed=9)[:, :60, :80].copy()
    frames[0] = 0.5
    tf = extract_batch(frames, device="cpu")
    assert tf.keypoints.count()[0] == 0 and (tf.descriptors[0] == 0).all()
    m = match(tf.descriptors[:1], tf.keypoints.valid[:1], tf.descriptors[1:], tf.keypoints.valid[1:],
              device="cpu")
    assert not m.accepted.any()
    jf = jax.jit(lambda im: extract_batch_fn(im, JaxAkazeConfig()))(jnp.asarray(frames))
    np.testing.assert_array_equal(tf.keypoints.valid.numpy(), np.asarray(jf.keypoints.valid))
    v = tf.keypoints.valid.numpy()
    np.testing.assert_array_equal(tf.keypoints.class_id.numpy()[v], np.asarray(jf.keypoints.class_id)[v])
    np.testing.assert_array_equal(interop.features_to_numpy(tf)["descriptors"][v],
                                  np.asarray(jf.descriptors)[v])
