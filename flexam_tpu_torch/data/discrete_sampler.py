"""SP-aware group-uniform diffusion-timestep sampling.

Port of `flexam_tpu/data/discrete_sampler.py` (reference
`FlexAM/utils/discrete_sampler.py:5-52`, `DiscreteSampling`): the world
splits into `group_num` groups, and every rank of one sequence-parallel
group draws its timesteps from the same sigma interval, so the SP shards
of one sample train on one timestep. The topology is explicit (world_size,
rank, sp_size); JAX draws with `jax.random.randint`, the port from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch


class DiscreteSampling:
    def __init__(self, num_idx: int, uniform_sampling: bool = False,
                 start_num_idx: int = 0, sp_size: int = 1,
                 world_size: int = 1, rank: int = 0):
        self.num_idx = num_idx
        self.start_num_idx = start_num_idx
        self.uniform_sampling = uniform_sampling and world_size > 1
        self.rank = rank
        if self.uniform_sampling:
            i = 1
            while world_size % i != 0 or num_idx % (world_size // i) != 0:
                i += 1
            if i >= sp_size:
                self.group_num = world_size // i
            elif sp_size > world_size:
                self.group_num = 1
            else:
                self.group_num = world_size // sp_size
            assert self.group_num > 0
            assert world_size % self.group_num == 0
            self.group_width = world_size // self.group_num
            self.sigma_interval = self.num_idx // self.group_num

    def bounds(self):
        """[lo, hi) of this rank's timestep indices."""
        if self.uniform_sampling:
            g = self.rank // self.group_width
            return (self.start_num_idx + g * self.sigma_interval,
                    self.start_num_idx + (g + 1) * self.sigma_interval)
        return self.start_num_idx, self.start_num_idx + self.num_idx

    def __call__(self, n_samples: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n_samples int64 indices in [lo, hi), drawn from `generator`
        (on its device)."""
        lo, hi = self.bounds()
        dev = generator.device if generator is not None else "cpu"
        return torch.randint(lo, hi, (n_samples,), generator=generator,
                             device=dev)
