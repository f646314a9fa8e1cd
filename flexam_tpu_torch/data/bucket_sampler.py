"""Aspect-ratio bucketed batching.

Port of `flexam_tpu/data/bucket_sampler.py`: the 512-base table
`ASPECT_RATIO_512` (reference `FlexAM/data/bucket_sampler.py:12-23`),
`get_closest_ratio` (`:40-43`, also the sampler node's resolution snap)
and `AspectRatioBucketSampler` (`AspectRatioBatchImageVideoSampler`,
`:270-378`): index batches of one (kind, bucket) group each.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


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


class AspectRatioBucketSampler:
    """Yields lists of dataset indices; each batch is one (kind, bucket)
    group, kind in {image, video}, in the order of a seeded permutation."""

    def __init__(self, sizes: Sequence[Tuple[int, int]],
                 is_video: Sequence[bool], batch_size: int,
                 drop_last: bool = True, seed: int = 0,
                 ratios: Dict = None):
        assert len(sizes) == len(is_video)
        self.sizes = sizes
        self.is_video = is_video
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.ratios = ratios or ASPECT_RATIO_512

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.RandomState(self.seed)
        buckets: Dict[Tuple, List[int]] = {}
        for idx in rng.permutation(len(self.sizes)):
            _, ratio = get_closest_ratio(*self.sizes[idx], self.ratios)
            key = ("video" if self.is_video[idx] else "image", ratio)
            bucket = buckets.setdefault(key, [])
            bucket.append(int(idx))
            if len(bucket) == self.batch_size:
                yield list(bucket)
                bucket.clear()
        if not self.drop_last:
            for bucket in buckets.values():
                if bucket:
                    yield list(bucket)
