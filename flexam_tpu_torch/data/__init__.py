"""Data helpers of the node pack: the aspect-ratio buckets that the
sampler node snaps a resolution to (`bucket_sampler`). The training data
pipeline of the JAX package (`flexam_tpu/data/`) is not ported yet
(ROADMAP A item 6)."""
