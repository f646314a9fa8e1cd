"""The OpenCV steps of the node pack, rebuilt without OpenCV.

The JAX package's nodes call `cv2` for three things, which the port (no
OpenCV on the card's machine) computes itself, equal to OpenCV 5 on every
pixel (`tests/test_torch_cv.py` holds them to `cv2`):

  * `rgb_to_gray_cv`: `cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)` of uint8
    images, OpenCV 5's 15-bit fixed point (9798 R + 19235 G + 3735 B +
    16384) >> 15, equal to it on all 256^3 colours (OpenCV 4's 14-bit
    weights 4899 / 9617 / 1868 differ from OpenCV 5 on 43,864 of them).
    PIL's luma (`media.to_gray_u8`, 16-bit weights) rounds otherwise, so
    it is not reused here;
  * `canny_u8`: `cv2.Canny(gray, low, high)` (aperture 3, L1 gradient): a
    3x3 Sobel with replicated borders, |dx| + |dy|, non-maximum suppression
    in OpenCV's fixed-point sectors (tan 22.5 deg as 13573 / 2^15) with its
    `>` on one side and `>=` on the other, a zero magnitude outside the
    image, and hysteresis over 8-neighbours from the pixels above `high`
    through those above `low`. The hysteresis is a connected-component
    labelling (union-find over the candidate pixels), which keeps the same
    pixels as OpenCV's stack. Integer work in torch, so it gives the
    same edges on every device;
  * `fill_circle`: `cv2.circle(canvas, center, radius, value, -1)`
    (LINE_8, no shift), OpenCV's midpoint scan with its horizontal spans.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_TG22 = 13573          # tan(22.5 deg) * 2^15
_SHIFT = 15


def rgb_to_gray_cv(img: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB -> [...] uint8 gray, as OpenCV's RGB2GRAY."""
    rgb = np.asarray(img)[..., :3].astype(np.int32)
    return ((rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)


def _clamped(x: torch.Tensor) -> torch.Tensor:
    """[T, H, W] -> [T, H + 2, W + 2] with replicated borders."""
    h, w = x.shape[-2:]
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    return x[:, rows][:, :, cols]


def _hysteresis(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """The candidates 8-connected to a strong pixel, by union-find over the
    candidate pixels: each round hooks the larger root of every linked pair
    under the smaller (a scatter-min) and compresses the paths, until no
    pair links two roots; a component is kept when it holds a strong
    pixel."""
    t, h, w = cand.shape
    dev = cand.device
    flat = cand.reshape(-1)
    idx = torch.arange(flat.numel(), device=dev).reshape(t, h, w)
    ps, qs = [], []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):   # each pair once
        lo, hi = max(0, -dx), w - max(0, dx)
        a = (slice(None), slice(0, h - dy), slice(lo, hi))
        b = (slice(None), slice(dy, h), slice(lo + dx, hi + dx))
        both = cand[a] & cand[b]
        ps.append(idx[a][both])
        qs.append(idx[b][both])
    p, q = torch.cat(ps), torch.cat(qs)
    parent = torch.arange(flat.numel(), device=dev)
    while True:
        rp, rq = parent[p], parent[q]
        link = rp != rq
        if not bool(link.any()):
            break
        parent.scatter_reduce_(0, torch.maximum(rp, rq)[link],
                               torch.minimum(rp, rq)[link], reduce="amin")
        while True:
            nxt = parent[parent]
            if torch.equal(nxt, parent):
                break
            parent = nxt
    keep = torch.zeros(flat.numel(), dtype=torch.bool, device=dev)
    keep[parent[strong.reshape(-1)]] = True
    return (keep[parent] & flat).reshape(t, h, w)


def canny_u8(gray: np.ndarray, low: float, high: float,
             device="cpu") -> np.ndarray:
    """`cv2.Canny(gray, low, high)` of uint8 [H, W] or [T, H, W] frames ->
    uint8 edges (0 or 255) of the same shape, computed on `device` (the
    host unless the caller asks for another: OpenCV's is host work)."""
    g = np.asarray(gray, np.uint8)
    single = g.ndim == 2
    x = torch.from_numpy(np.ascontiguousarray(g[None] if single else g))
    x = x.to(device=device, dtype=torch.int32)
    if low > high:
        low, high = high, low
    low, high = math.floor(low), math.floor(high)
    t, h, w = x.shape
    p = _clamped(x)
    dx = (p[:, :h, 2:] - p[:, :h, :w] + 2 * (p[:, 1:h + 1, 2:]
          - p[:, 1:h + 1, :w]) + p[:, 2:, 2:] - p[:, 2:, :w])
    dy = (p[:, 2:, :w] - p[:, :h, :w] + 2 * (p[:, 2:, 1:w + 1]
          - p[:, :h, 1:w + 1]) + p[:, 2:, 2:] - p[:, :h, 2:])
    m = dx.abs() + dy.abs()
    mp = torch.nn.functional.pad(m, (1, 1, 1, 1))     # 0 outside the image
    left, right = mp[:, 1:-1, :-2], mp[:, 1:-1, 2:]
    up, down = mp[:, :-2, 1:-1], mp[:, 2:, 1:-1]
    ax = dx.abs().long()
    ay = dy.abs().long() << _SHIFT
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << (_SHIFT + 1))
    horiz = ay < tg22
    vert = ~horiz & (ay > tg67)
    same = (dx ^ dy) >= 0                   # OpenCV's s = +1
    diag_same = (m > mp[:, :-2, :-2]) & (m > mp[:, 2:, 2:])
    diag_diff = (m > mp[:, :-2, 2:]) & (m > mp[:, 2:, :-2])
    peak = torch.where(horiz, (m > left) & (m >= right),
                       torch.where(vert, (m > up) & (m >= down),
                                   torch.where(same, diag_same, diag_diff)))
    cand = (m > low) & peak
    edges = _hysteresis(cand, cand & (m > high))
    out = (edges.to(torch.uint8) * 255).cpu().numpy()
    return out[0] if single else out


def fill_circle(canvas: np.ndarray, center: Tuple[int, int], radius: int,
                value) -> np.ndarray:
    """`cv2.circle(canvas, center, radius, value, thickness=-1)` in place
    (LINE_8, shift 0): OpenCV's `Circle` scan, which fills the horizontal
    span of each of the eight octant points. `center` is (x, y). Returns
    the canvas."""
    hgt, wid = canvas.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = (radius <= cx < wid - radius) and (radius <= cy < hgt - radius)

    def span(y, x0, x1):
        if inside or 0 <= y < hgt:
            canvas[y, x0:x1 + 1] = value

    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            span(y11, x11, x12)
            span(y12, x11, x12)
            span(y21, x21, x22)
            span(y22, x21, x22)
        elif x11 < wid and x12 >= 0 and y21 < hgt and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, wid - 1)
            span(y11, x11, x12)
            span(y12, x11, x12)
            if x21 < wid and x22 >= 0:
                span(y21, max(x21, 0), min(x22, wid - 1))
                span(y22, max(x21, 0), min(x22, wid - 1))
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return canvas
