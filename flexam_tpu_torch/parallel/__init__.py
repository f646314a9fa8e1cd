"""Multi-GPU execution of the port: the mesh, sequence- and
tensor-parallel attention and linears, the width-split VAE and the sharded
training step, on `torch.distributed`.

Port of `flexam_tpu/parallel/`. JAX runs one controller over global
arrays: one mesh of devices, and GSPMD inserts the collectives. torch runs
one process a rank (SPMD), so this package says exactly what each rank
holds. It uses explicit local shards, the reference's own xDiT / NCCL
design (JAX `models/dit.py:544-546` cites the reference's manual chunk and
all-gather, `wan_transformer3d_FlexAM.py:971-975,1103-1104`):

  * each rank holds its token slice and its slice of the weights;
  * the collectives are explicit `torch.distributed` calls (`comm.py`),
    differentiable where training runs through them.

Not DTensor: the kernels B1-B6 are launched through ctypes on the raw
pointers of local, contiguous tensors (`ops/flash_attention.py`), and
DTensor's sharding propagation cannot see inside them.

What the public functions take and return:

  * the attention functions (`make_ulysses_attention`,
    `make_ring_attention`, `make_usp_attention`; `mesh(q, k, v, k_len,
    scale)`) take and return this rank's LOCAL token slice
    [B/dp, L/sp, H, D];
  * `dit_forward` under `activation_sharding(mesh)`, the pipeline's
    `generate` / `denoise`, `t5_encode` and `vae_decode_sharded` /
    `vae_encode_sharded` return the whole result on every rank, as JAX
    returns a global array.

Ranks are started by `torchrun` on several cards, or by `launch.run` (the
tests and the smoke: ranks that share one card, over gloo, since NCCL
refuses two ranks on one device).
"""

from flexam_tpu_torch.parallel.sharding import (  # noqa: F401
    Layout,
    Mesh,
    Shard,
    activation_sharding,
    active_mesh,
    clear_mesh,
    dit_param_shardings,
    make_mesh,
    replicated_shardings,
    set_mesh,
    shard_pytree,
    t5_param_shardings,
    token_layout,
)
