"""3D rotary position embeddings with the Wan t/h/w frequency split.

Port of `flexam_tpu/core/rope.py`. The angle tables are numpy (fp64 math,
stored fp32); head_dim d splits into complex dims t = (d - 4*(d//6))/2,
h = w = d//6. Pairs are INTERLEAVED, (x[2j], x[2j+1]), and rotated in fp32:
  out_even = x_e*cos - x_o*sin ;  out_odd = x_e*sin + x_o*cos.
Tokens past the table length stay unrotated. RIFLEx is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _axis_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    """freqs[i] = 1/theta^(2i/dim), i < dim//2 (fp64)."""
    assert dim % 2 == 0
    return 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)


def rope_split(head_dim: int) -> Tuple[int, int, int]:
    """Per-axis complex dims (t, h, w): head_dim 128 -> (22, 21, 21)."""
    d = head_dim
    return (d - 4 * (d // 6)) // 2, d // 6, d // 6


def rope_angles(max_seq: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Angle table [max_seq, dim//2] = outer(pos, freqs)."""
    freqs = _axis_freqs(dim, theta)
    return (np.arange(max_seq, dtype=np.float64)[:, None] * freqs
            ).astype(np.float32)


def make_rope_tables(head_dim: int, max_seq: int = 1024) -> np.ndarray:
    """Concatenated angle table [max_seq, head_dim//2] in (t | h | w) order."""
    d = head_dim
    dt2 = d - 4 * (d // 6)
    ds2 = 2 * (d // 6)
    return np.concatenate([rope_angles(max_seq, dt2), rope_angles(max_seq, ds2),
                           rope_angles(max_seq, ds2)], axis=1)


def build_video_rope(tables: torch.Tensor, grid: Tuple[int, int, int],
                     head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (cos, sin), each [F*H*W, head_dim//2] fp32, for grid
    (F, H, W) in row-major (f, h, w) token order."""
    f, h, w = grid
    dt, ds, _ = rope_split(head_dim)
    t_tab = tables[:f, :dt]
    h_tab = tables[:h, dt:dt + ds]
    w_tab = tables[:w, dt + ds:dt + 2 * ds]
    ang = torch.cat([
        t_tab[:, None, None, :].expand(f, h, w, dt),
        h_tab[None, :, None, :].expand(f, h, w, ds),
        w_tab[None, None, :, :].expand(f, h, w, ds),
    ], dim=-1).reshape(f * h * w, head_dim // 2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of x [..., L, n_heads, head_dim] by
    (cos, sin) [L_rot, head_dim//2] in fp32; positions >= L_rot pass
    through unrotated. Returns x.dtype."""
    L, half = x.shape[-3], x.shape[-1] // 2
    lr = min(cos.shape[0], L)
    c = torch.ones((L, half), dtype=torch.float32, device=x.device)
    s = torch.zeros((L, half), dtype=torch.float32, device=x.device)
    c[:lr] = cos[:lr]
    s[:lr] = sin[:lr]
    c, s = c[:, None, :], s[:, None, :]
    xf = x.float()
    xe, xo = xf[..., 0::2], xf[..., 1::2]
    out_e = xe * c - xo * s
    out_o = xe * s + xo * c
    return torch.stack([out_e, out_o], dim=-1).reshape(x.shape).to(x.dtype)
