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

The pose renderer (`perception/pose_render.py`) draws with four more of
OpenCV's primitives, and DWPose's pre-processing (`perception/dwpose.py`)
takes three geometry calls; each is rebuilt here in OpenCV 5's own
arithmetic and equals it (`tests/test_torch_pose_render.py`):

  * `ellipse2poly`: `cv2.ellipse2Poly`, the points from OpenCV's table of
    sines at whole degrees (7 decimals, stored as float32), rounded half to
    even and deduplicated;
  * `fill_convex_poly`: `cv2.fillConvexPoly` (LINE_8) at shift 0, and at
    the 16-bit fixed point of a thick line: the outline through OpenCV's
    line walkers, then the rows between the two edges that walk down from
    the top vertex;
  * `draw_line`: `cv2.line` (LINE_8), thickness 1 a Bresenham walk,
    thicker lines clipped to the canvas grown by the thickness, then a
    fixed-point quadrilateral with a filled circle at each end (OpenCV's
    `ThickLine`);
  * `hsv_to_rgb`: matplotlib's `hsv_to_rgb`;
  * `resize_u8_linear`: `cv2.resize` INTER_LINEAR of uint8 images, OpenCV's
    11-bit fixed point with its vectorized vertical pass;
  * `get_affine_transform`: `cv2.getAffineTransform`, OpenCV's LU solve of
    the 6x6 system in float64, in its order;
  * `warp_affine_u8`: `cv2.warpAffine` INTER_LINEAR with a constant border
    of 0 on uint8, OpenCV 5's float32 kernel (source coordinates and
    interpolation in float32, rounded half to even).

The training data's colour jitter (`data/augment.py`) rotates hue through
HSV: `rgb_to_hsv_u8` / `hsv_to_rgb_u8` are `cv2.cvtColor` COLOR_RGB2HSV /
COLOR_HSV2RGB of uint8 images (H in 0..179), equal to OpenCV 5 on all 256^3
inputs (`tests/test_torch_cv.py`). RGB2HSV is OpenCV's 12-bit fixed point
with its rounded division tables. HSV2RGB is float32 arithmetic in which
OpenCV's build fuses `1 - s*h` into one FMA; its vectorized loop takes each
row's first multiple of 32 pixels (4 vectors of 8 floats, the AVX2 build
OpenCV dispatches) and truncates there, while its scalar tail rounds half
to even: the port keeps both, by column.

The streamed decoder's YUV 4:2:0 fetch (`models/vae_stream.py`) is turned
back into RGB by `yuv420_to_rgb`: `cv2.cvtColor` COLOR_YUV2RGB_I420,
OpenCV's BT.601 limited-range inverse in 20-bit fixed point, each 2x2
block sharing its U and V, equal to OpenCV 5 on all 256^3 (Y, U, V).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

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


# ---------------------------------------------------------------------------
# The pose renderer's drawing (OpenCV's drawing.cpp)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
# OpenCV's SinTable: sin of 0..450 degrees written with 7 decimals, float32
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7
                      ).astype(np.float32).astype(np.float64)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def ellipse2poly(center: Tuple[int, int], axes: Tuple[int, int],
                 angle: int, arc_start: int, arc_end: int,
                 delta: int) -> np.ndarray:
    """`cv2.ellipse2Poly` of integer arguments -> int32 points [N, 2]."""
    if not 0 < delta <= 180:
        raise ValueError("ellipse2poly: delta must be in (0, 180]")
    cx, cy = float(center[0]), float(center[1])
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    # OpenCV's sincos keeps them in float
    alpha, beta = _SIN_TABLE[450 - angle], _SIN_TABLE[angle]
    a = np.minimum(np.arange(arc_start, arc_end + delta, delta), arc_end)
    a = np.where(a < 0, a + 360, a)
    x = axes[0] * _SIN_TABLE[450 - a]
    y = axes[1] * _SIN_TABLE[a]
    # cvRound rounds half to even, as np.rint
    pts = np.stack([np.rint(cx + x * alpha - y * beta),
                    np.rint(cy + x * beta + y * alpha)], axis=1)
    keep = np.ones(len(pts), bool)
    keep[1:] = (pts[1:] != pts[:-1]).any(axis=1)
    pts = pts[keep]
    if len(pts) == 1:
        pts = np.asarray([center, center], np.float64)
    return pts.astype(np.int32).reshape(-1, 2)


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's `clipLine` to [0, w) x [0, h): clipped (p1, p2), or None
    where the segment misses the rectangle."""
    if w <= 0 or h <= 0:
        return None
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line8(canvas: np.ndarray, p1, p2, color) -> None:
    """OpenCV's `Line` (an 8-connected `LineIterator`, left to right)."""
    h, w = canvas.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w
            and 0 <= p1[1] < h and 0 <= p2[1] < h):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus, minus = dx + dx, -(dy + dy)
    x, y = p1
    for _ in range(dx + 1):
        canvas[y, x] = color
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


def _line2(canvas: np.ndarray, p1, p2, color) -> None:
    """OpenCV's `Line2`: a line between 16-bit fixed-point ends."""
    h, w = canvas.shape[:2]
    clipped = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _XY_ONE, _cdiv(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv(dx << _XY_SHIFT, ay | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    half = _XY_ONE >> 1
    x1 += half
    y1 += half

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            canvas[y, x] = color

    put((x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT)
    if ax > ay:
        x1 >>= _XY_SHIFT
        for _ in range(count + 1):
            put(x1, y1 >> _XY_SHIFT)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= _XY_SHIFT
        for _ in range(count + 1):
            put(x1 >> _XY_SHIFT, y1)
            x1 += x_step
            y1 += 1


def fill_convex_poly(canvas: np.ndarray, pts, color, shift: int = 0
                     ) -> np.ndarray:
    """`cv2.fillConvexPoly(canvas, pts, color)` (LINE_8) in place, `pts`
    integer [N, 2] (x, y) with `shift` fractional bits. Returns the
    canvas."""
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    npts = len(v)
    if npts == 0:
        return canvas
    h, w = canvas.shape[:2]
    up = _XY_SHIFT - shift
    delta = 1 << shift >> 1
    # the outline
    p0 = (v[-1][0] << up, v[-1][1] << up)
    imin = 0
    ymin = ymax = v[0][1]
    xmin = xmax = v[0][0]
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        p = (x << up, y << up)
        if shift == 0:
            _line8(canvas, (p0[0] >> _XY_SHIFT, p0[1] >> _XY_SHIFT),
                   (p[0] >> _XY_SHIFT, p[1] >> _XY_SHIFT), color)
        else:
            _line2(canvas, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return canvas
    ymax = min(ymax, h - 1)
    # the rows between the two edges that walk down from the top vertex
    half = _XY_ONE >> 1
    idx = [imin, imin]
    di = [1, npts - 1]
    ex = [-_XY_ONE, -_XY_ONE]
    edx = [0, 0]
    ye = [ymin, ymin]
    edges = npts
    y = ymin
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx[i]
                nxt = idx0 + di[i]
                if nxt >= npts:
                    nxt -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[nxt][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[nxt][0] << up
                        ye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs
                        idx[i] = nxt
                        break
                    idx0 = nxt
                    nxt += di[i]
                    if nxt >= npts:
                        nxt -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            x1 = (ex[left] + half) >> _XY_SHIFT
            x2 = (ex[right] + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                canvas[y, max(x1, 0):min(x2, w - 1) + 1] = color
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        # rows above the canvas draw nothing: skip to the next edge change
        skip = min(ye[0], ye[1], 0) - y
        if skip > 0:
            ex[0] += edx[0] * skip
            ex[1] += edx[1] * skip
            y += skip
        if y > ymax:
            break
    return canvas


def draw_line(canvas: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int],
              color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(canvas, p1, p2, color, thickness)` (LINE_8, shift 0) in
    place; a float colour rounds half to even, as OpenCV's `saturate_cast`.
    Returns the canvas."""
    color = np.clip(np.rint(np.asarray(color, np.float64)), 0, 255
                    ).astype(canvas.dtype)
    color = color[:canvas.shape[2]] if canvas.ndim == 3 else color[0]
    x0, y0 = int(p1[0]), int(p1[1])
    x1, y1 = int(p2[0]), int(p2[1])
    if thickness <= 1:
        _line8(canvas, (x0, y0), (x1, y1), color)
        return canvas
    # OpenCV clips a thick line to the canvas grown by the thickness first
    h, w = canvas.shape[:2]
    clipped = _clip_line(w + 2 * thickness, h + 2 * thickness,
                         (x0 + thickness, y0 + thickness),
                         (x1 + thickness, y1 + thickness))
    if clipped is None:
        return canvas
    (x0, y0), (x1, y1) = ((x - thickness, y - thickness)
                          for x, y in clipped)
    q0 = (x0 << _XY_SHIFT, y0 << _XY_SHIFT)
    q1 = (x1 << _XY_SHIFT, y1 << _XY_SHIFT)
    dx = (q0[0] - q1[0]) / _XY_ONE
    dy = (q1[1] - q0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half_t = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half_t + odd * _XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        quad = [(q0[0] + dpx, q0[1] + dpy), (q0[0] - dpx, q0[1] - dpy),
                (q1[0] - dpx, q1[1] - dpy), (q1[0] + dpx, q1[1] + dpy)]
        fill_convex_poly(canvas, quad, color, shift=_XY_SHIFT)
    radius = (half_t + (_XY_ONE >> 1)) >> _XY_SHIFT
    for q in (q0, q1):                  # the round caps
        fill_circle(canvas, ((q[0] + (_XY_ONE >> 1)) >> _XY_SHIFT,
                             (q[1] + (_XY_ONE >> 1)) >> _XY_SHIFT),
                    radius, color)
    return canvas


def hsv_to_rgb(hsv: Sequence[float]) -> np.ndarray:
    """matplotlib's `colors.hsv_to_rgb` of one (h, s, v) in [0, 1]."""
    h, s, v = (float(c) for c in hsv)
    i = int(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    if s == 0:
        return np.asarray([v, v, v])
    return np.asarray([(v, t, p), (q, v, p), (p, v, t), (p, q, v),
                       (t, p, v), (v, p, q)][i % 6])


# ---------------------------------------------------------------------------
# DWPose's pre-processing geometry (OpenCV's resize.cpp, imgwarp.cpp)
# ---------------------------------------------------------------------------

_RESIZE_COEF = np.float32(2048)          # INTER_RESIZE_COEF_SCALE, 11 bits


def linear_taps(in_n: int, out_n: int, clamp: bool = True,
                dtype=np.float32):
    """OpenCV's INTER_LINEAR taps for one axis: the source position in
    `dtype` from float64 (d + 0.5) * scale - 0.5, its floor and its
    fraction in `dtype` -> (first index, second index, fraction). Columns
    clamp the position at the borders (`clamp`); rows keep it and clip the
    indices. float32 is the rule of OpenCV's uint8 resize; on float
    frames OpenCV 5.0.0 comes within 1e-6 of float64 positions and not of
    float32 ones (1.1e-6 at 20 -> 33 rows), so
    `media.resize_frames_linear` asks for float64."""
    scale = 1.0 / (out_n / in_n)
    f = ((np.arange(out_n) + 0.5) * scale - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(dtype)).astype(dtype)
    if clamp:
        low, high = s < 0, s >= in_n - 1
        f = np.where(low | high, f.dtype.type(0), f)
        s = np.where(low, 0, np.where(high, in_n - 1, s))
    return np.clip(s, 0, in_n - 1), np.clip(s + 1, 0, in_n - 1), f


def _fixed_weights(f: np.ndarray):
    """The two 11-bit weights of float32 fractions, rounded half to even."""
    return (np.rint((np.float32(1) - f) * _RESIZE_COEF).astype(np.int32),
            np.rint(f * _RESIZE_COEF).astype(np.int32))


def resize_u8_linear(frames: np.ndarray, size: Tuple[int, int]
                     ) -> np.ndarray:
    """`cv2.resize(frame, (w, h))` (INTER_LINEAR) of uint8 frames
    [T, H, W, C] -> [T, h, w, C], `size` = (h, w). OpenCV's fixed point:
    the row pass sums the two 11-bit-weighted pixels exactly, and the
    vectorized column pass takes each sum >> 4, multiplies it by its 11-bit
    weight keeping the high 16 bits, adds the two and rounds off 2 more
    bits ((a + b + 2) >> 2), saturated to 0..255."""
    x = np.asarray(frames)
    h, w = size
    if x.shape[1:3] == (h, w):
        return x.copy()
    x0, x1, fx = linear_taps(x.shape[2], w)
    y0, y1, fy = linear_taps(x.shape[1], h, clamp=False)
    (a0, a1), (b0, b1) = _fixed_weights(fx), _fixed_weights(fy)
    src = x.astype(np.int32)
    rows = (src[:, :, x0] * a0[None, None, :, None]
            + src[:, :, x1] * a1[None, None, :, None])   # [T, H, w, C]
    b0 = b0[None, :, None, None]
    b1 = b1[None, :, None, None]
    out = ((((rows[:, y0] >> 4) * b0) >> 16)
           + (((rows[:, y1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """`cv2.getAffineTransform(src, dst)` of three float32 point pairs ->
    the float64 2x3 matrix: OpenCV's 6x6 system solved by its LU
    (partial pivoting on the largest magnitude, back substitution dividing
    by each pivot), in its order of operations."""
    p = np.asarray(src, np.float32).astype(np.float64)
    q = np.asarray(dst, np.float32).astype(np.float64)
    a = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        a[2 * i, :3] = a[2 * i + 1, 3:] = (p[i, 0], p[i, 1], 1.0)
        b[2 * i], b[2 * i + 1] = q[i]
    for i in range(6):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if abs(a[k, i]) < np.finfo(np.float64).eps:
            raise ValueError("get_affine_transform: degenerate points")
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, 6):
            alpha = a[j, i] * d
            for c in range(i + 1, 6):
                a[j, c] += alpha * a[i, c]
            b[j] += alpha * b[i]
    for i in range(5, -1, -1):
        s = b[i]
        for c in range(i + 1, 6):
            s -= a[i, c] * b[c]
        b[i] = s / a[i, i]
    return b.reshape(2, 3)


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine_u8(img: np.ndarray, mat: np.ndarray,
                   dsize: Tuple[int, int]) -> np.ndarray:
    """`cv2.warpAffine(img, mat, dsize, flags=INTER_LINEAR)` (constant
    border 0) of a uint8 [H, W, C] image, `dsize` = (w, h). OpenCV 5 inverts
    the matrix in float64, then works in float32: per row M1 * y + M2, per
    pixel a fused M0 * x + that, the floor and fraction, the two horizontal
    then the vertical fused interpolations, rounded half to even; a
    neighbour outside the image reads 0."""
    m = np.asarray(mat, np.float64).reshape(-1).copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[1], m[3], m[4] = a11, m[1] * -det, m[3] * -det, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    m = m.astype(np.float32)
    w, h = dsize
    src = np.asarray(img)
    hs, ws = src.shape[:2]
    xs = np.arange(w, dtype=np.float32)[None]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = _fma32(m[0], xs, ys * m[1] + m[2])
    sy = _fma32(m[3], xs, ys * m[4] + m[5])
    ix, iy = np.floor(sx), np.floor(sy)
    ax = (sx - ix)[..., None]
    ay = (sy - iy)[..., None]
    # a zero border of one pixel: a neighbour outside the image reads it
    pix = np.zeros((hs + 2, ws + 2, src.size // (hs * ws)), np.float32)
    pix[1:-1, 1:-1] = src.reshape(hs, ws, -1)
    pix = pix.reshape((hs + 2) * (ws + 2), -1)
    cols = [np.clip(ix + d, 0, ws + 1).astype(np.int64) for d in (1, 2)]
    rows = [np.clip(iy + d, 0, hs + 1).astype(np.int64) * (ws + 2)
            for d in (1, 2)]

    def tap(r, c):
        return pix[rows[r] + cols[c]]

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma32(ax, p01 - p00, p00)
    bot = _fma32(ax, p11 - p10, p10)
    out = np.clip(np.rint(_fma32(ay, bot - top, top)), 0, 255)
    return out.astype(np.uint8).reshape((h, w) + src.shape[2:])


# ---------------------------------------------------------------------------
# RGB <-> HSV (uint8, H in 0..179)
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12
# pixels a row of OpenCV's vectorized HSV2RGB loop takes at a time
HSV_SIMD_COLUMNS = 32


def _hsv_tables():
    """OpenCV's `sdiv_table` and `hdiv_table180`: saturate_cast<int> of
    (255 << 12) / i and (180 << 12) / (6 i), rounded half to even."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2HSV)` of uint8 [..., 3]."""
    x = np.asarray(img).astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    sdiv, hdiv = _hsv_tables()
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fnma1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 fma(-a, b, 1): one rounding (the float32 product is exact
    in float64)."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(
        np.float32)


# (b, g, r) picks from (v, p, q, t) by sector (OpenCV's `sector_data`)
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_u8(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_HSV2RGB)` of uint8 [..., W, 3] (H
    scaled by 6 / 180; any byte is taken, as OpenCV takes it)."""
    x = np.asarray(img)
    f32 = np.float32
    h = x[..., 0].astype(f32) * f32(6.0 / 180)
    s = x[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = x[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    frac = (h - sector).astype(f32)
    tab = np.stack([v, v * (f32(1) - s), v * _fnma1(s, frac),
                    v * _fnma1(s, f32(1) - frac)], -1)
    bgr = np.take_along_axis(
        tab, _HSV_SECTORS[sector.astype(np.int64) % 6], -1) * f32(255)
    w = x.shape[-2]
    simd = np.arange(w) < w - w % HSV_SIMD_COLUMNS
    out = np.where(simd[:, None], np.trunc(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


# OpenCV's ITUR_BT_601 constants (color_yuv.simd.hpp): the inverse of the
# limited-range BT.601 matrix scaled by 2^20
_I420_CY, _I420_CUB, _I420_CUG = 1220542, 2116026, -409993
_I420_CVG, _I420_CVR, _I420_SHIFT = -852492, 1673527, 20


def yuv420_to_rgb(luma, uv) -> torch.Tensor:
    """(Y [B, T, H, W], UV planar [B, T, 2, H/2, W/2]) uint8 -> RGB uint8
    [B, T, H, W, 3], as `cv2.cvtColor(i420, COLOR_YUV2RGB_I420)` frame by
    frame. Integer work in torch (numpy arrays or tensors in, a tensor on
    their device out)."""
    y = torch.as_tensor(luma).to(torch.int32)
    c = torch.as_tensor(uv).to(torch.int32) - 128
    b, t, h, w = y.shape
    u, v = c[:, :, 0, :, None, :, None], c[:, :, 1, :, None, :, None]
    half = 1 << (_I420_SHIFT - 1)
    yy = ((y - 16).clamp_min(0) * _I420_CY + half).view(
        b, t, h // 2, 2, w // 2, 2)
    planes = [yy + _I420_CVR * v, yy + _I420_CVG * v + _I420_CUG * u,
              yy + _I420_CUB * u]
    rgb = torch.stack([(p >> _I420_SHIFT).clamp(0, 255).to(torch.uint8)
                       for p in planes], dim=-1)
    return rgb.view(b, t, h, w, 3)
