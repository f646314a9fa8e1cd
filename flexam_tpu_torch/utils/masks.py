"""Mask synthesis for foreground / background edits.

Port of `flexam_tpu/utils/masks.py`. The foreground mask there is OpenCV's:
a Gaussian blur and re-threshold, the convex hull of each external contour
(`findContours(RETR_EXTERNAL)` + `convexHull` + `fillPoly`) and a dilation by
an ellipse of (2 * dilation_pixels + 1)^2 (`MORPH_ELLIPSE`). The port
rebuilds each step without OpenCV:

  * the blur is the same `scipy.ndimage.gaussian_filter` call;
  * each 8-connected component (`scipy.ndimage.label`; the external
    contours are the components' outer borders, and a component inside
    another's hole lies inside that one's hull) gets the convex hull of its
    pixels, strictly convex (collinear points dropped). A component whose
    pixels lie on one line has a contour of two points, which JAX skips,
    and is skipped here too;
  * `fillPoly`'s fill is rebuilt as OpenCV draws it: every hull edge as an
    8-connected Bresenham line (`LineIterator`, left to right), then the
    scanlines between the active edges in 16.16 fixed point, each row
    filled from ceil(x_left) to floor(x_right);
  * the ellipse is `getStructuringElement`'s formula, and the dilation runs
    on `device` as a union of horizontal spans, one per row of the ellipse
    (prefix sums along each row give every span's "any pixel set" at once).

`tests/test_torch_cli.py` holds the result to the JAX function bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from flexam_tpu_torch.device import resolve_device

_XY_SHIFT = 16


def _hull(points: np.ndarray) -> np.ndarray:
    """Strictly convex hull (monotone chain) of integer (x, y) points, in
    order; fewer than 3 vertices when the points are collinear."""
    pts = np.unique(points, axis=0)
    if len(pts) < 3:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def chain(seq):
        out: List[Tuple[int, int]] = []
        for p in seq:
            while len(out) >= 2:
                (ax, ay), (bx, by) = out[-2], out[-1]
                if (bx - ax) * (p[1] - ay) - (by - ay) * (p[0] - ax) > 0:
                    break
                out.pop()
            out.append((int(p[0]), int(p[1])))
        return out

    lower, upper = chain(pts), chain(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.int64).reshape(-1, 2)


def _line8(img: np.ndarray, p0, p1) -> None:
    """OpenCV's 8-connected line (`LineIterator`, left to right)."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    h, w = img.shape
    for _ in range(major + 1):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = 1
        diag = err < 0
        err += -2 * minor + (2 * major if diag else 0)
        if steep:
            y += sy
            x += 1 if diag else 0
        else:
            x += 1
            y += sy if diag else 0


def _fill_convex(img: np.ndarray, hull: np.ndarray) -> None:
    """`cv2.fillPoly(img, [hull], 1)` for a convex polygon with integer
    vertices (shift 0, LINE_8): the edges drawn as lines, then each
    scanline between the two active edges."""
    n = len(hull)
    edges = []
    for i in range(n):
        (x0, y0), (x1, y1) = hull[i - 1], hull[i]
        _line8(img, (int(x0), int(y0)), (int(x1), int(y1)))
        if y0 == y1:
            continue
        if y0 > y1:
            x0, y0, x1, y1 = x1, y1, x0, y0
        xf = int(x0) << _XY_SHIFT
        # C's int64 division truncates toward zero
        num = (int(x1) - int(x0)) << _XY_SHIFT
        den = int(y1) - int(y0)
        step = abs(num) // den * (1 if num >= 0 else -1)
        edges.append((int(y0), int(y1), xf, step))
    h, w = img.shape
    for y in range(max(min(e[0] for e in edges), 0) if edges else 0,
                   min(max(e[1] for e in edges), h) if edges else 0):
        xs = [xf + (y - y0) * step for y0, y1, xf, step in edges
              if y0 <= y < y1]
        if len(xs) < 2:
            continue
        # ceil(x_left) .. floor(x_right); the edges' pixels come from the lines
        lo = (min(xs) + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
        hi = max(xs) >> _XY_SHIFT
        if lo < w and hi >= 0:
            img[y, max(lo, 0):min(hi, w - 1) + 1] = 1


def convex_hull_fill(mask: np.ndarray) -> np.ndarray:
    """[H, W] {0, 1} -> the union of the filled convex hulls of its
    8-connected components (components on one line are skipped)."""
    from scipy.ndimage import label
    lab, n = label(mask > 0, structure=np.ones((3, 3), int))
    out = np.zeros(mask.shape, np.uint8)
    if n == 0:
        return out
    ys, xs = np.nonzero(lab)
    ids = lab[ys, xs]
    order = np.argsort(ids, kind="stable")
    splits = np.cumsum(np.bincount(ids, minlength=n + 1))[:-1]
    for pts in np.split(np.stack([xs, ys], 1)[order], splits[1:]):
        hull = _hull(pts)
        if len(hull) >= 3:
            _fill_convex(out, hull)
    return out


def ellipse_half_widths(radius: int) -> np.ndarray:
    """Half widths of the rows of `cv2.getStructuringElement(MORPH_ELLIPSE,
    (2r+1, 2r+1))`, rows -r..r."""
    r = c = radius
    inv_r2 = 1.0 / (r * r) if r else 0.0
    dy = np.arange(-r, r + 1, dtype=np.float64)
    return np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)).astype(np.int64)


def dilate_ellipse(masks: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation of [N, H, W] masks by the (2r+1)^2 ellipse, on the
    masks' device: the union over the ellipse's rows of each row's
    horizontal span, shifted by the row's offset (`cv2.dilate`; pixels
    outside the image add nothing)."""
    n, h, w = masks.shape
    dev = masks.device
    prefix = torch.zeros((n, h, w + 1), dtype=torch.int32, device=dev)
    prefix[..., 1:] = masks.to(torch.int32).cumsum(-1)
    xs = torch.arange(w, device=dev)
    out = torch.zeros((n, h, w), dtype=torch.bool, device=dev)
    spans = {}
    for dy, hw in zip(range(-radius, radius + 1),
                      ellipse_half_widths(radius).tolist()):
        if abs(dy) >= h:
            continue
        if hw not in spans:
            hi = (xs + hw + 1).clamp(max=w)
            lo = (xs - hw).clamp(min=0)
            spans[hw] = (prefix[..., hi] - prefix[..., lo]) > 0
        span = spans[hw]
        # out[y] |= span[y + dy]
        if dy >= 0:
            out[:, :h - dy] |= span[:, dy:]
        else:
            out[:, -dy:] |= span[:, :h + dy]
    return out


def generate_mask_fg_tracking(mask_video: np.ndarray, blur_radius: int = 15,
                              dilation_pixels: int = 200,
                              device="cuda") -> np.ndarray:
    """mask_video: [F, C, H, W] in [0, 1]. Returns [F, 1, H, W] uint8 {0,1};
    frame 0 always zero. Blur, components and hulls run on the host, the
    dilation on `device`."""
    from scipy.ndimage import gaussian_filter

    f, c, h, w = mask_video.shape
    out = np.zeros((f, 1, h, w), np.uint8)
    gray = mask_video.mean(axis=1) if c > 1 else mask_video[:, 0]
    hulls = np.zeros((max(f - 1, 0), h, w), np.uint8)
    for i in range(1, f):
        m = (gray[i] > 0.5).astype(np.uint8) * 255
        if blur_radius > 0:
            blurred = gaussian_filter(m.astype(np.float32) / 255.0,
                                      sigma=blur_radius / 6.0)
            m = (blurred > 0.5).astype(np.uint8) * 255
        hulls[i - 1] = convex_hull_fill(m)
    if f > 1:
        if dilation_pixels > 0:
            dev = resolve_device(device)
            hulls = dilate_ellipse(torch.from_numpy(hulls).to(dev) > 0,
                                   dilation_pixels).cpu().numpy()
        out[1:, 0] = hulls > 0
    return out


def generate_mask_bg_tracking(mask_video: np.ndarray) -> np.ndarray:
    """mask_video: [F, C, H, W]. Returns [F, 1, H, W] float {0,1} with
    frame 0 zero; dark pixels (< 0.5) become 1."""
    f, c, h, w = mask_video.shape
    out = np.zeros((f, 1, h, w), np.float32)
    gray = (mask_video.mean(axis=1, keepdims=True) if c > 1
            else mask_video[:, :1])
    norm = gray / 255.0 if gray.max() > 1.0 else gray
    out[1:] = (norm[1:] < 0.5).astype(np.float32)
    return out
