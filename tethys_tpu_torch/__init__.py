"""PyTorch + CUDA port of tethys_tpu's Whisper serving path.

The JAX package ``tethys_tpu`` is the reference; this package mirrors its
module names.  Every Pallas kernel on the serving path is a CUDA C++
kernel for Hopper (``csrc/``), built with ``nvcc`` at first use; each has a
plain PyTorch version beside it, which runs for CPU tensors only.
"""
