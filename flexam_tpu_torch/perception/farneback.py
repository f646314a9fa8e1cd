"""OpenCV's Farneback dense optical flow, in torch on the frames' device.

JAX's host flow tracker calls `cv2.calcOpticalFlowFarneback`
(`flexam_tpu/perception/tracking.py:197-200`); the port has no OpenCV, so
this module follows OpenCV's CPU algorithm (`optflowgf.cpp`) step by step:

  * the pyramid: levels are added while both sides stay >= 32 px after
    scaling; level k (scale pyr_scale^k) blurs the full-size frame with a
    Gaussian of sigma (1/scale - 1) / 2 (kernel max(round(5 sigma) | 1, 3),
    OpenCV's fixed [1, 2, 1] / 4 at sigma 0, reflect-101 borders), then
    resizes it INTER_LINEAR to round(size * scale);
  * from the coarsest level down, the flow starts at zero, then is the
    coarser level's flow resized INTER_LINEAR and divided by pyr_scale;
  * `_poly_exp` (FarnebackPolyExp): the quadratic expansion of each frame
    over a (2 poly_n + 1)^2 Gaussian window (poly_sigma), separable, rows
    replicated at the borders, the vertical pass in float32 and the
    horizontal one in float64, as OpenCV's;
  * `_update_matrices` (FarnebackUpdateMatrices): the second frame's
    expansion sampled at x + flow, averaged with the first's, and the
    5-entry border fade (0.14, 0.14, 0.4472, 0.4472, 0.4472);
  * `_update_flow` (FarnebackUpdateFlow_Blur, flags 0): a winsize box filter
    of the matrices with replicated borders (in float64, as OpenCV's running
    sums), the 2x2 solve with OpenCV's +1e-3 on the determinant, and new
    matrices from the new flow after every iteration but the last.

The filters are shifted multiply-adds, not convolutions, so no TF32 path
can change the card's result. Summation orders differ from OpenCV's
vectorized code, so the flow is held to `cv2` within a bound its tests
state, not bit for bit. Many frame pairs run as one batch
(`farneback_pairs`).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from flexam_tpu_torch.utils.cv import linear_taps

_MIN_SIZE = 32
_BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
# getGaussianKernel's fixed kernels (odd sizes up to 7, sigma <= 0)
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                       0.109375, 0.03125]}


def _gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """OpenCV's `getGaussianKernel(n, sigma, CV_32F)`."""
    if sigma <= 0 and n in _SMALL_GAUSSIAN:
        t = np.asarray(_SMALL_GAUSSIAN[n], np.float32)
    else:
        s = sigma if sigma > 0 else ((n - 1) * 0.5 - 1) * 0.3 + 0.8
        x = np.arange(n) - (n - 1) * 0.5
        t = np.exp(-0.5 / (s * s) * x * x).astype(np.float32)
    total = 1.0 / float(t.astype(np.float64).sum())
    return (t.astype(np.float64) * total).astype(np.float32)


def _sep_filter(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """[B, H, W] float32 filtered by the separable kernel `k` along rows
    then columns, reflect-101 borders, as shifted multiply-adds."""
    r = len(k) // 2
    kt = [float(v) for v in k]
    for dim in (2, 1):
        n = x.shape[dim]
        idx = torch.arange(-r, n + r, device=x.device)
        idx = idx.abs()
        idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        idx = idx.clamp(0, n - 1)
        p = x.index_select(dim, idx)
        acc = p.narrow(dim, 0, n) * kt[0]
        for i in range(1, len(kt)):
            acc = acc + p.narrow(dim, i, n) * kt[i]
        x = acc
    return x


def _linear_taps(in_n: int, out_n: int, device):
    """OpenCV's INTER_LINEAR taps of a float image along one axis (its
    clamped float32 positions): (first index, second index, 1 - fraction,
    fraction) on `device`."""
    s0, s1, f = linear_taps(in_n, out_n)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (s0, s1, np.float32(1) - f, f))


def _resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`cv2.resize(x, (w, h))` INTER_LINEAR of float32 [B, H, W(, C)]:
    columns, then rows."""
    h, w = size
    if x.shape[1:3] == (h, w):
        return x
    extra = (1,) * (x.dim() - 3)
    s0, s1, a0, a1 = _linear_taps(x.shape[2], w, x.device)
    x = (x.index_select(2, s0) * a0.view(1, 1, -1, *extra)
         + x.index_select(2, s1) * a1.view(1, 1, -1, *extra))
    s0, s1, a0, a1 = _linear_taps(x.shape[1], h, x.device)
    return (x.index_select(1, s0) * a0.view(1, -1, 1, *extra)
            + x.index_select(1, s1) * a1.view(1, -1, 1, *extra))


def _poly_kernels(n: int, sigma: float):
    """FarnebackPrepareGaussian: g, x g, x^2 g (float32) and the four
    entries of the inverse moment matrix OpenCV reads."""
    if sigma < np.finfo(np.float32).eps:
        sigma = n * 0.3
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2 * sigma * sigma)).astype(np.float32)
    s = 1.0 / float(g.astype(np.float64).sum())
    g = (g.astype(np.float64) * s).astype(np.float32)
    xg = (x * g.astype(np.float64)).astype(np.float32)
    xxg = (x * x * g.astype(np.float64)).astype(np.float32)
    gg = np.outer(g.astype(np.float64), g.astype(np.float64))
    xx = (x * x).astype(np.float64)[None, :]
    yy = (x * x).astype(np.float64)[:, None]
    G = np.zeros((6, 6))
    G[0, 0] = gg.sum()
    G[1, 1] = (gg * xx).sum()
    G[3, 3] = (gg * xx * xx).sum()
    G[5, 5] = (gg * xx * yy).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5])


def _poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """FarnebackPolyExp of [B, H, W] float32 -> [B, H, W, 5] float32:
    (r_y, r_x, r_yy, r_xx, r_xy) in OpenCV's channel order."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_kernels(n, sigma)
    b, h, w = img.shape
    dev = img.device
    rows = torch.arange(h, device=dev)
    # vertical pass, float32, rows clamped
    t0 = img * float(g[n])
    t1 = torch.zeros_like(img)
    t2 = torch.zeros_like(img)
    for k in range(1, n + 1):
        up = img.index_select(1, (rows - k).clamp_min(0))
        down = img.index_select(1, (rows + k).clamp_max(h - 1))
        p = up + down
        t0 = t0 + float(g[n + k]) * p
        t1 = t1 + float(xg[n + k]) * (down - up)
        t2 = t2 + float(xxg[n + k]) * p
    # horizontal pass, float64 sums of float32 pair sums, columns clamped
    cols = torch.arange(w, device=dev)
    f64 = torch.float64
    b1 = (t0 * float(g[n])).to(f64)
    b3 = (t1 * float(g[n])).to(f64)
    b5 = (t2 * float(g[n])).to(f64)
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        left = (cols - k).clamp_min(0)
        right = (cols + k).clamp_max(w - 1)
        r0, l0 = t0.index_select(2, right), t0.index_select(2, left)
        r1, l1 = t1.index_select(2, right), t1.index_select(2, left)
        r2, l2 = t2.index_select(2, right), t2.index_select(2, left)
        tg = (r0 + l0).to(f64)
        b1 = b1 + tg * float(g[n + k])
        b4 = b4 + tg * float(xxg[n + k])
        b2 = b2 + (r0 - l0).to(f64) * float(xg[n + k])
        b3 = b3 + (r1 + l1).to(f64) * float(g[n + k])
        b6 = b6 + (r1 - l1).to(f64) * float(xg[n + k])
        b5 = b5 + (r2 + l2).to(f64) * float(g[n + k])
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=-1
                       ).to(torch.float32)


def _border_scale(n: int, device) -> torch.Tensor:
    s = torch.ones(n, dtype=torch.float32)
    for i, v in enumerate(_BORDER[:n]):
        s[i] = s[i] * v
        s[n - 1 - i] = s[n - 1 - i] * v
    return s.to(device)


def _update_matrices(r0: torch.Tensor, r1: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateMatrices: [B, H, W, 5] expansions and [B, H, W, 2]
    flow -> [B, H, W, 5] (G11, G12, G22, h1, h2)."""
    b, h, w, _ = r0.shape
    dev = r0.device
    dx, dy = flow[..., 0], flow[..., 1]
    fx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) + dx
    fy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1) + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1, fy - y1
    x1, y1 = x1.long(), y1.long()
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    xi, yi = x1.clamp(0, w - 2), y1.clamp(0, h - 2)
    flat = r1.reshape(b, h * w, 5)

    def tap(yy, xx):
        idx = (yy * w + xx).reshape(b, h * w, 1).expand(b, h * w, 5)
        return flat.gather(1, idx).reshape(b, h, w, 5)

    one = torch.ones((), dtype=torch.float32, device=dev)
    a00 = ((one - fx) * (one - fy))[..., None]
    a01 = (fx * (one - fy))[..., None]
    a10 = ((one - fx) * fy)[..., None]
    a11 = (fx * fy)[..., None]
    s = (a00 * tap(yi, xi) + a01 * tap(yi, xi + 1) + a10 * tap(yi + 1, xi)
         + a11 * tap(yi + 1, xi + 1))
    ins = inside[..., None]
    s = torch.where(ins, s, torch.zeros_like(s))
    r4 = torch.where(inside, (r0[..., 2] + s[..., 2]) * 0.5, r0[..., 2])
    r5 = torch.where(inside, (r0[..., 3] + s[..., 3]) * 0.5, r0[..., 3])
    r6 = torch.where(inside, (r0[..., 4] + s[..., 4]) * 0.25,
                     r0[..., 4] * 0.5)
    r2 = (r0[..., 0] - s[..., 0]) * 0.5
    r3 = (r0[..., 1] - s[..., 1]) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    scale = (_border_scale(h, dev).view(1, h, 1)
             * _border_scale(w, dev).view(1, 1, w))
    r2, r3, r4, r5, r6 = (t * scale for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=-1)


def _box(x: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    """A (2m + 1)-wide box sum along `dim` with replicated borders, by
    running sums (float64)."""
    n = x.shape[dim]
    idx = torch.arange(-m - 1, n + m, device=x.device).clamp(0, n - 1)
    c = torch.cumsum(x.index_select(dim, idx), dim=dim)
    return c.narrow(dim, 2 * m + 1, n) - c.narrow(dim, 0, n)


def _update_flow(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """FarnebackUpdateFlow_Blur's solve: the box-filtered matrices ->
    [B, H, W, 2] float32 flow."""
    half = winsize // 2
    s = _box(_box(m.to(torch.float64), 1, half), 2, half)
    s = s * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = s.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=-1
                       ).to(torch.float32)


def farneback_pairs(frames: torch.Tensor, prev_idx, next_idx,
                    pyr_scale: float = 0.5, levels: int = 3,
                    winsize: int = 15, iterations: int = 3,
                    poly_n: int = 5, poly_sigma: float = 1.2,
                    flags: int = 0) -> torch.Tensor:
    """Farneback flow from frames[prev_idx[j]] to frames[next_idx[j]] for
    every j, in one batch: uint8 (or float) [T, H, W] frames on a device ->
    [len(prev_idx), H, W, 2] float32 on that device. Each frame that a
    pair reads is expanded once a level, and no other."""
    if flags != 0:
        raise NotImplementedError(
            "calc_optical_flow_farneback: flags other than 0 "
            "(OPTFLOW_USE_INITIAL_FLOW, OPTFLOW_FARNEBACK_GAUSSIAN) are not "
            "ported; the flow tracker passes 0")
    if frames.dim() != 3:
        raise ValueError("farneback_pairs: frames are [T, H, W] gray")
    dev = frames.device
    prev_idx = torch.as_tensor(prev_idx, dtype=torch.long, device=dev)
    next_idx = torch.as_tensor(next_idx, dtype=torch.long, device=dev)
    # only the frames the pairs read are filtered and expanded
    used, inv = torch.unique(torch.cat([prev_idx, next_idx]),
                             return_inverse=True)
    frames = frames.index_select(0, used)
    prev_idx, next_idx = inv[:len(prev_idx)], inv[len(prev_idx):]
    rows, cols = frames.shape[1:]
    scale = 1.0
    k = 0
    while k < levels:
        scale *= pyr_scale
        if cols * scale < _MIN_SIZE or rows * scale < _MIN_SIZE:
            break
        k += 1
    levels = k
    full = frames.to(torch.float32)
    flow = None
    for k in range(levels, -1, -1):
        scale = pyr_scale ** k
        sigma = (1.0 / scale - 1) * 0.5
        ksz = max(round(sigma * 5) | 1, 3)
        width, height = round(cols * scale), round(rows * scale)
        if flow is None:
            flow = torch.zeros((len(prev_idx), height, width, 2),
                               dtype=torch.float32, device=dev)
        else:
            flow = _resize_linear(flow, (height, width)) * (1.0 / pyr_scale)
        img = _resize_linear(_sep_filter(full, _gaussian_kernel(ksz, sigma)),
                             (height, width))
        r = _poly_exp(img, poly_n, poly_sigma)
        r0, r1 = r.index_select(0, prev_idx), r.index_select(0, next_idx)
        m = _update_matrices(r0, r1, flow)
        for i in range(iterations):
            flow = _update_flow(m, winsize)
            if i < iterations - 1:
                m = _update_matrices(r0, r1, flow)
    return flow


def calc_optical_flow_farneback(
        prev_u8: Union[np.ndarray, torch.Tensor],
        next_u8: Union[np.ndarray, torch.Tensor],
        pyr_scale: float = 0.5, levels: int = 3, winsize: int = 15,
        iterations: int = 3, poly_n: int = 5, poly_sigma: float = 1.2,
        flags: int = 0) -> torch.Tensor:
    """`cv2.calcOpticalFlowFarneback(prev, next, None, ...)` of two uint8
    [H, W] frames -> [H, W, 2] float32 flow, on the tensors' device (numpy
    frames run on the CPU)."""
    frames = torch.stack([torch.as_tensor(np.asarray(f)) if not
                          isinstance(f, torch.Tensor) else f
                          for f in (prev_u8, next_u8)])
    return farneback_pairs(frames, [0], [1], pyr_scale, levels, winsize,
                           iterations, poly_n, poly_sigma, flags)[0]
