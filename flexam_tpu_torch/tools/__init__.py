"""Measurement scripts for the port, run on a CUDA card with
`python -m flexam_tpu_torch.tools.<name>`."""
