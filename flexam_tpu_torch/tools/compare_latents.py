"""Latent / video PSNR comparison tool.

A copy of `flexam_tpu/tools/compare_latents.py` (numpy), so that the port
needs nothing of the JAX package to compare dumps from either stack:

  python -m flexam_tpu_torch.tools.compare_latents ours.npz theirs.npz
  python -m flexam_tpu_torch.tools.compare_latents ours.npz theirs.npz --key latents

Dumps are .npz files of arrays (every key the two share is compared; .npy
and torch .pt accepted too). `--per-step` compares [T_steps, ...]
trajectories step by step. Exit status 0 when the worst PSNR reaches
`--threshold` (40 dB by default), 1 when it does not; "no common keys"
exits with that message.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = None) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    if peak is None:
        peak = max(np.abs(a).max(), np.abs(b).max())
    return 10.0 * np.log10(peak ** 2 / mse)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0,
         win: int = 7) -> float:
    """Mean SSIM over the last two (spatial) axes with a uniform `win`
    window (the standard k1=0.01 / k2=0.03 constants); leading axes are
    independent images, averaged. Close to scikit-image's
    `structural_similarity(..., use_sample_covariance=True)` (about 1e-3 on
    natural images)."""
    a = np.asarray(a, np.float64).reshape(-1, *a.shape[-2:])
    b = np.asarray(b, np.float64).reshape(-1, *b.shape[-2:])
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2

    def _box(x):
        # separable uniform filter, valid region only
        k = np.ones(win) / win
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, x)
        return np.apply_along_axis(lambda r: np.convolve(r, k, "valid"),
                                   2, x)

    mu_a, mu_b = _box(a), _box(b)
    saa = _box(a * a) - mu_a ** 2
    sbb = _box(b * b) - mu_b ** 2
    sab = _box(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2)
    return float(np.mean(num / den))


def _load(path: str):
    if path.endswith(".npy"):
        return {"array": np.load(path)}
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith((".pt", ".pth")):
        import torch
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(obj, "numpy"):
            return {"array": obj.float().numpy()}
        return {k: v.float().numpy() for k, v in obj.items()}
    raise ValueError(f"unsupported dump format: {path}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ours")
    p.add_argument("theirs")
    p.add_argument("--key", default=None)
    p.add_argument("--per-step", action="store_true")
    p.add_argument("--threshold", type=float, default=40.0)
    args = p.parse_args(argv)

    a, b = _load(args.ours), _load(args.theirs)
    keys = [args.key] if args.key else sorted(set(a) & set(b))
    if not keys:
        sys.exit("no common keys between dumps")
    worst = float("inf")
    for k in keys:
        if a[k].shape != b[k].shape:
            print(f"{k}: SHAPE MISMATCH {a[k].shape} vs {b[k].shape}")
            worst = -1.0
            continue
        if args.per_step:
            for i, (x, y) in enumerate(zip(a[k], b[k])):
                v = psnr(x, y)
                worst = min(worst, v)
                print(f"{k}[{i}]: {v:.2f} dB")
        else:
            v = psnr(a[k], b[k])
            worst = min(worst, v)
            print(f"{k}: {v:.2f} dB")
    status = "PASS" if worst >= args.threshold else "FAIL"
    print(f"worst: {worst:.2f} dB (threshold {args.threshold}) -> {status}")
    if worst < args.threshold:
        sys.exit(1)


if __name__ == "__main__":
    main()
