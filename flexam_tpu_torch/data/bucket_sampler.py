"""Aspect-ratio buckets.

Port of the part of `flexam_tpu/data/bucket_sampler.py` that the sampler
node uses (`nodes.py`'s resolution snap): the 512-base table
`ASPECT_RATIO_512` (reference `FlexAM/data/bucket_sampler.py:12-23`) and
`get_closest_ratio` (`:40-43`). The batch sampler belongs to training
(ROADMAP A item 6).
"""

from __future__ import annotations

from typing import Dict, Tuple


def _build_512_table() -> Dict[str, Tuple[float, float]]:
    """The PixArt-style 512-base bucket grid: heights/widths on a 32px
    grid with h*w ~= 512^2 (the reference table's values)."""
    table = {}
    heights = [256, 288, 320, 352, 384, 416, 448, 480, 512, 544, 576, 608,
               640, 672, 704, 736, 768, 800, 832, 864, 896, 928, 960, 992,
               1024]
    widths = {256: [1024, 992, 960, 928], 288: [896, 864, 832],
              320: [800, 768], 352: [736, 704, 672], 384: [672, 640],
              416: [608, 576], 448: [576, 544], 480: [544, 512],
              512: [512, 480], 544: [480, 448], 576: [448, 416],
              608: [416], 640: [384], 672: [384], 704: [352], 736: [352],
              768: [320], 800: [320], 832: [288], 864: [288], 896: [288],
              928: [256], 960: [256], 992: [256], 1024: [256]}
    for h in heights:
        for w in widths.get(h, []):
            key = f"{round(h / w, 2):g}"
            table[key] = (float(h), float(w))
    return table


ASPECT_RATIO_512 = _build_512_table()


def get_closest_ratio(height: float, width: float,
                      ratios: Dict = None) -> Tuple[Tuple[float, float], float]:
    """(the bucket (h, w) whose h / w is nearest height / width, its key
    as a float)."""
    ratios = ratios or ASPECT_RATIO_512
    ar = height / width
    key = min(ratios.keys(), key=lambda r: abs(float(r) - ar))
    return ratios[key], float(key)
