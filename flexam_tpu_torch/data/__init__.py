"""The training data layer (port of `flexam_tpu/data/`): the aspect-ratio
buckets and their batch sampler, SP-group timestep sampling, colour
jitter and the annotation-driven datasets (`dataset`)."""

from flexam_tpu_torch.data.bucket_sampler import (  # noqa: F401
    ASPECT_RATIO_512,
    AspectRatioBucketSampler,
    get_closest_ratio,
)
from flexam_tpu_torch.data.discrete_sampler import DiscreteSampling  # noqa: F401
