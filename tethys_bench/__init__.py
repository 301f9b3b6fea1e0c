"""The benchmark of tethys_tpu_torch on NVIDIA GPUs (see README.md)."""
