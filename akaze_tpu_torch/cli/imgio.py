"""Image and feature-file IO of the port's CLI tools (own copy of the JAX
package's `akaze_tpu/cli/imgio.py`).

Grayscale loaders for .npy/.npz, binary and ASCII PGM (own parser), and
anything PIL opens where PIL exists; features serialize as JSON or as the
versioned .npz schema.  Both formats are the JAX package's: a file written
by either package loads in the other with equal arrays.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from akaze_tpu_torch.interop import features_to_numpy

FEATURE_SCHEMA_VERSION = 1
_KEYPOINT_FIELDS = ("x", "y", "response", "size", "octave", "class_id", "angle")


def load_gray(path: str | pathlib.Path) -> np.ndarray:
    """Load a grayscale image as float32 (H, W) in [0, 1]."""
    path = pathlib.Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        img = np.load(path)
    elif suffix == ".npz":
        with np.load(path) as z:
            img = z[z.files[0]]
    elif suffix in (".pgm", ".ppm"):
        img = _load_pnm(path)
    else:
        try:
            from PIL import Image  # optional dependency
        except ImportError as e:
            raise RuntimeError(f"cannot load {path}: install PIL or use .npy/.npz/.pgm") from e
        img = np.asarray(Image.open(path).convert("F"), np.float32) / 255.0
    img = np.asarray(img, np.float32)
    if img.ndim == 3:  # RGB -> luma
        img = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    if img.max() > 1.5:  # 8/16-bit range
        img = img / (65535.0 if img.max() > 255.5 else 255.0)
    return np.ascontiguousarray(img, np.float32)


def _load_pnm(path: pathlib.Path) -> np.ndarray:
    data = path.read_bytes()
    parts = []
    i = 0
    # Header tokens (magic, width, height, maxval), comments skipped.
    while len(parts) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        parts.append(data[i:j])
        i = j
    magic, w, h, maxval = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    i += 1  # single whitespace after maxval
    if magic == b"P5":
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        img = np.frombuffer(data, dtype, count=w * h, offset=i).reshape(h, w)
        return img.astype(np.float32) / maxval
    if magic == b"P2":
        vals = np.array(data[i:].split(), np.float32)[: w * h].reshape(h, w)
        return vals / maxval
    raise ValueError(f"unsupported PNM magic {magic!r} in {path}")


def features_to_dict(features) -> dict:
    """One frame's `Features` -> JSON-serializable dict: the valid
    keypoints as records and their descriptors as hex strings."""
    a = features_to_numpy(features)
    valid = a["valid"]
    kps = [
        {name: (int(a[name][i]) if name in ("octave", "class_id") else float(a[name][i]))
         for name in _KEYPOINT_FIELDS}
        for i in np.nonzero(valid)[0]
    ]
    return {
        "schema_version": FEATURE_SCHEMA_VERSION,
        "keypoints": kps,
        "descriptors": [d.tobytes().hex() for d in a["descriptors"][valid]],
    }


def save_features(path: str | pathlib.Path, features) -> None:
    """Write one frame's `Features` (valid slots only) as .npz or JSON."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".npz":
        a = features_to_numpy(features)
        valid = a["valid"]
        np.savez_compressed(
            path,
            schema_version=FEATURE_SCHEMA_VERSION,
            **{name: a[name][valid] for name in _KEYPOINT_FIELDS},
            descriptors=a["descriptors"][valid],
        )
    else:
        path.write_text(json.dumps(features_to_dict(features), indent=1))


def load_features(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """Load a saved feature file back into numpy arrays."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    obj = json.loads(path.read_text())
    kps = obj["keypoints"]
    desc = np.array(
        [np.frombuffer(bytes.fromhex(h), np.uint32) for h in obj["descriptors"]]
    ).reshape(len(obj["descriptors"]), -1)
    out = {"descriptors": desc, "schema_version": np.int64(obj["schema_version"])}
    for field in _KEYPOINT_FIELDS:
        out[field] = np.array([k[field] for k in kps])
    return out
