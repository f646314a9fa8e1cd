"""Track normalization, coloring, cosine positional encoding.

Behavioral reference: `pipelines.py:1501-1761` (color generation inside
`fun_visualize_tracking_with_depth`, `apply_cosine_positional_encoding`,
`_generate_colors_from_points`). The port's own copy of
`flexam_tpu/conditioning/tracks.py`, with its own Spectral colormap table
in place of matplotlib's, equal to it entry for entry."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def normalize_tracks(tracks: np.ndarray, height: int, width: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """(u, v, z) -> normalized [0, 1]^3: u/W, v/H, percentile-normalized
    inverse depth (`pipelines.py:1592-1633`)."""
    t = np.asarray(tracks, np.float64)
    out = np.zeros_like(t)
    out[..., 0] = np.clip(t[..., 0] / width, 0, 1)
    out[..., 1] = np.clip(t[..., 1] / height, 0, 1)
    z = t[..., 2]
    if np.all(z == 0):
        r = rng or np.random
        out[..., 2] = r.rand(*z.shape)
    else:
        inv_z = 1.0 / (z + 1e-10)
        p2, p98 = np.percentile(inv_z, [2, 98])
        out[..., 2] = np.clip((inv_z - p2) / (p98 - p2 + 1e-10), 0, 1)
    return out.astype(np.float32)


def cosine_positional_encoding(tracks: np.ndarray, height: int, width: int,
                               L: int = 4) -> List[np.ndarray]:
    """cos(2^i * pi * normalized_uvz) for i in 0..L-1
    (`apply_cosine_positional_encoding`, `pipelines.py:1575-1641`)."""
    normalized = normalize_tracks(tracks, height, width)
    return [np.cos((2.0 ** i) * np.pi * normalized).astype(np.float32)
            for i in range(L)]


def tracking_colors(tracks: np.ndarray, height: int, width: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> np.ndarray:
    """Per-point uint8 colors from FRAME-0 (u, v, 1/z): R = u/W, G = v/H,
    B = percentile-normalized inverse depth (`pipelines.py:1521-1540`)."""
    first = np.asarray(tracks[0], np.float64)
    n = first.shape[0]
    colors = np.zeros((n, 3), np.uint8)
    colors[:, 0] = (np.clip(first[:, 0] / width, 0, 1) * 255).astype(np.uint8)
    colors[:, 1] = (np.clip(first[:, 1] / height, 0, 1) * 255).astype(np.uint8)
    z = first[:, 2]
    if np.all(z == 0):
        r = rng or np.random
        colors[:, 2] = r.randint(0, 256, n).astype(np.uint8)
    else:
        inv_z = 1.0 / (z + 1e-10)
        p2, p98 = np.percentile(inv_z, [2, 98])
        colors[:, 2] = (np.clip((inv_z - p2) / (p98 - p2 + 1e-10), 0, 1)
                        * 255).astype(np.uint8)
    return colors


def cos_level_colors(encoded_frame0: np.ndarray) -> np.ndarray:
    """Colors for one cosine level from its frame-0 encoding in [-1, 1]
    (`_generate_colors_from_points`, `pipelines.py:1677-1693`)."""
    e = np.asarray(encoded_frame0, np.float64)
    return (np.clip((e + 1) / 2, 0, 1) * 255).astype(np.uint8)


# matplotlib's "Spectral": the 11 ColorBrewer stops (RGB in [0, 1], as
# matplotlib's `_cm._Spectral_data` writes them), spaced evenly on [0, 1]
_SPECTRAL_STOPS = np.array([
    (0.6196078431372549, 0.00392156862745098, 0.25882352941176473),
    (0.8352941176470589, 0.24313725490196078, 0.30980392156862746),
    (0.9568627450980393, 0.42745098039215684, 0.2627450980392157),
    (0.9921568627450981, 0.6823529411764706, 0.3803921568627451),
    (0.996078431372549, 0.8784313725490196, 0.5450980392156862),
    (1.0, 1.0, 0.7490196078431373),
    (0.9019607843137255, 0.9607843137254902, 0.596078431372549),
    (0.6705882352941176, 0.8666666666666667, 0.6431372549019608),
    (0.4, 0.7607843137254902, 0.6470588235294118),
    (0.19607843137254902, 0.5333333333333333, 0.7411764705882353),
    (0.3686274509803922, 0.30980392156862746, 0.6352941176470588),
])


def spectral_lut(n: int = 256) -> np.ndarray:
    """[n, 3] float64 RGB table of the Spectral colormap: the stops
    interpolated linearly at linspace(0, 1, n), computed as matplotlib's
    `LinearSegmentedColormap.from_list(..., N=n)` computes its table."""
    x = np.linspace(0, 1, len(_SPECTRAL_STOPS)) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    cols = []
    for y in _SPECTRAL_STOPS.T:
        lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1])
                              + y[ind - 1], [y[-1]]])
        cols.append(np.clip(lut, 0.0, 1.0))
    return np.stack(cols, axis=1)


_SPECTRAL = spectral_lut()


def spectral_colormap(x: np.ndarray) -> np.ndarray:
    """RGB [..., 3] in [0, 1] of floats x, as matplotlib's colormap call
    maps them: entry min(int(x * 256), 255), the ends below 0 and above 1,
    and black for NaN."""
    n = len(_SPECTRAL)
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), -1, n).astype(int)
    rgb = _SPECTRAL[np.clip(idx, 0, n - 1)]
    rgb[bad] = 0.0
    return rgb


def spectral_depth_colors(depths: np.ndarray) -> np.ndarray:
    """Per-frame Spectral-colormap colors from percentile-normalized depth
    (`_visualize_depth_tracking`, `pipelines.py:1782-1795`)."""
    p2, p98 = np.percentile(depths, [2, 98])
    if p98 > p2:
        norm = (np.clip(depths, p2, p98) - p2) / (p98 - p2)
    else:
        norm = np.zeros_like(depths)
    return (spectral_colormap(norm) * 255).astype(np.uint8)
