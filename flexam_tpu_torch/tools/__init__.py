"""Scripts of the port, run with `python -m flexam_tpu_torch.tools.<name>`:
measurements on a CUDA card (serving_bench, attention_ab, decode_probe),
checkpoint tools (prequant_ckpt, verify_ckpt) and compare_latents."""
