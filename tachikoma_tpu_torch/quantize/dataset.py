"""Calibration / evaluation datasets (port of
`tachikoma_tpu/quantize/dataset.py`).

Named sources feeding calibration and evaluation, none of which needs the
network:

  * `from_npz`   — any user-provided .npz with `data` (+ optional `labels`);
  * `digits`     — sklearn's BUNDLED handwritten-digits set (1,797 labeled
                   8x8 images) — real data, real labels; it needs sklearn,
                   and without it raises an ImportError that says so;
  * `synthetic_images` — deterministic structured images (blobs + gradients
                   + band-limited textures) for float-vs-int8 AGREEMENT
                   measurements on architectures whose trained weights are
                   not at hand (agreement needs representative activation
                   statistics, not semantic labels).

Every dataset is a plain (data, labels) pair with batching and a
calibration/evaluation split, so `quantize(...)` and `accuracy.eval_topk`
consume the same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class Dataset:
    data: np.ndarray               # (N, ...) float32, model input layout
    labels: Optional[np.ndarray]   # (N,) int labels or None
    name: str = "dataset"

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def batches(self, batch: int, limit: int | None = None,
                pad_last: bool = True) -> Iterator[tuple[np.ndarray, int]]:
        """Yield (batch_array, n_valid); the final short batch is padded by
        repeating its first sample (graphs are compiled at a fixed batch)."""
        n = len(self) if limit is None else min(limit, len(self))
        for i in range(0, n, batch):
            chunk = self.data[i:i + batch]
            valid = chunk.shape[0]
            if valid < batch:
                if not pad_last:
                    return
                reps = np.repeat(chunk[:1], batch - valid, axis=0)
                chunk = np.concatenate([chunk, reps], axis=0)
            yield np.ascontiguousarray(chunk), valid

    def split(self, calib_n: int) -> tuple["Dataset", "Dataset"]:
        """Deterministic calibration/evaluation split (first calib_n)."""
        lab = self.labels
        return (
            Dataset(self.data[:calib_n],
                    None if lab is None else lab[:calib_n],
                    f"{self.name}[calib]"),
            Dataset(self.data[calib_n:],
                    None if lab is None else lab[calib_n:],
                    f"{self.name}[eval]"),
        )


def from_npz(path: str) -> Dataset:
    """Load `data` (+ optional `labels`) arrays from an .npz file."""
    z = np.load(path)
    if "data" not in z:
        raise ValueError(f"{path}: expected a 'data' array "
                         f"(found {sorted(z.keys())})")
    labels = z["labels"].astype(np.int64) if "labels" in z else None
    return Dataset(z["data"].astype(np.float32), labels, name=path)


def digits(layout: str = "NHWC") -> Dataset:
    """sklearn's bundled handwritten digits: 1,797 labeled 8x8 grayscale
    images, pixel values scaled to [0, 1].  Shuffled with a fixed seed so
    the calib/eval split is class-balanced."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError("quantize.dataset.digits needs scikit-learn (sklearn), which is not "
                          "installed; use synthetic_images or from_npz instead") from e

    d = load_digits()
    imgs = (d.images / 16.0).astype(np.float32)
    order = np.random.default_rng(0).permutation(len(imgs))
    imgs, labels = imgs[order], d.target[order].astype(np.int64)
    if layout == "NHWC":
        data = imgs[..., None]
    elif layout == "NCHW":
        data = imgs[:, None]
    elif layout == "flat":
        data = imgs.reshape(len(imgs), -1)
    else:
        raise ValueError(layout)
    return Dataset(data, labels, name="digits")


def synthetic_images(n: int, shape: tuple, seed: int = 0,
                     name: str = "synthetic") -> Dataset:
    """Deterministic structured images in the model's input layout
    (H, W, C) per sample: per-channel gradients + gaussian blobs +
    band-limited sinusoidal textures + noise, roughly zero-mean/unit-range —
    non-degenerate statistics for conv/BN activations, unlike iid noise."""
    h, w = int(shape[0]), int(shape[1])
    c = int(shape[2]) if len(shape) > 2 else 1
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    out = np.empty((n, h, w, c), np.float32)
    for i in range(n):
        img = np.zeros((h, w, c), np.float32)
        # smooth gradient
        gx, gy = rng.normal(0, 0.5, 2)
        img += (gx * xx + gy * yy)[..., None].astype(np.float32)
        # gaussian blobs
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(-0.8, 0.8, 2)
            s = rng.uniform(0.08, 0.4)
            amp = rng.normal(0, 1.2, c).astype(np.float32)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
            img += blob[..., None].astype(np.float32) * amp
        # band-limited texture
        fx, fy = rng.uniform(2, 10, 2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.normal(0, 0.4, c).astype(np.float32)
        img += np.sin(fx * xx + fy * yy + ph)[..., None].astype(np.float32) * amp
        img += rng.normal(0, 0.08, img.shape).astype(np.float32)
        out[i] = img
    return Dataset(out, None, name=name)


def synthetic_labeled(n: int, shape: tuple = (64, 64, 3),
                      num_classes: int = 32, seed: int = 0,
                      name: str = "synthetic-labeled") -> Dataset:
    """Class-conditional structured images — a LABELED synthetic dataset a
    real CNN can be trained on to high accuracy (the round-4 accuracy table
    used unlabeled random-weight near-ties; this gives the mrt `Trace.eval`
    analog confident logits to measure quantization DEGRADATION against).

    Each class is a fixed signature (3 gaussian blob sites with per-channel
    amplitudes + one band-limited texture) drawn from a class-seeded rng;
    each sample renders the signature with jittered blob centers/widths,
    amplitude jitter, a random global gradient, and iid noise — enough
    intra-class variation that the task is non-trivial but cleanly
    learnable (>=0.9 float top-1 with a small ResNet).  Deterministic in
    (n, shape, num_classes, seed): tests regenerate it instead of storing
    arrays."""
    h, w = int(shape[0]), int(shape[1])
    c = int(shape[2]) if len(shape) > 2 else 1
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    # class signatures (independent of n: stable as the set grows)
    sigs = []
    for k in range(num_classes):
        cr = np.random.default_rng(100_000 + 977 * seed + k)
        sigs.append({
            "centers": cr.uniform(-0.7, 0.7, (3, 2)),
            "widths": cr.uniform(0.12, 0.30, 3),
            "amps": cr.normal(0, 1.4, (3, c)),
            "freq": cr.uniform(2.5, 9.0, 2),
            "phase": cr.uniform(0, 2 * np.pi),
            "tex_amp": cr.normal(0, 0.5, c),
        })
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n).astype(np.int64)
    out = np.empty((n, h, w, c), np.float32)
    for i in range(n):
        s = sigs[labels[i]]
        img = np.zeros((h, w, c), np.float32)
        gx, gy = rng.normal(0, 0.35, 2)
        img += (gx * xx + gy * yy)[..., None].astype(np.float32)
        for b in range(3):
            cx, cy = s["centers"][b] + rng.normal(0, 0.18, 2)
            sw = s["widths"][b] * rng.uniform(0.7, 1.45)
            amp = (s["amps"][b] * rng.normal(1.0, 0.45, c)).astype(np.float32)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                            / (2 * sw * sw)))
            img += blob[..., None].astype(np.float32) * amp
        fx, fy = s["freq"] * rng.uniform(0.85, 1.18, 2)
        ph = s["phase"] + rng.uniform(-0.9, 0.9)
        tex = (s["tex_amp"] * rng.normal(1.0, 0.4, c)).astype(np.float32)
        img += np.sin(fx * xx + fy * yy + ph)[..., None].astype(
            np.float32) * tex
        img += rng.normal(0, 0.8, img.shape).astype(np.float32)
        out[i] = img
    return Dataset(out, labels, name=name)


def get_dataset(spec: str, input_shape: tuple, samples: int = 200,
                seed: int = 0) -> Dataset:
    """CLI dataset spec: 'digits' | 'synthetic' | 'synthetic-labeled'
    | path to .npz."""
    if spec == "digits":
        layout = "flat" if len(input_shape) == 2 else (
            "NCHW" if len(input_shape) == 4 and input_shape[1] in (1, 3)
            and input_shape[1] < input_shape[-1] else "NHWC")
        return digits(layout)
    if spec == "synthetic":
        return synthetic_images(samples, tuple(input_shape[1:]), seed=seed)
    if spec == "synthetic-labeled":
        shp = tuple(input_shape[1:])
        nchw = (len(input_shape) == 4 and input_shape[1] in (1, 3)
                and input_shape[1] < input_shape[-1])
        if nchw:
            shp = (input_shape[2], input_shape[3], input_shape[1])
        ds = synthetic_labeled(samples, shp, seed=seed)
        if nchw:   # data rides in the MODEL's input layout
            ds = Dataset(np.ascontiguousarray(
                ds.data.transpose(0, 3, 1, 2)), ds.labels, ds.name)
        return ds
    return from_npz(spec)
