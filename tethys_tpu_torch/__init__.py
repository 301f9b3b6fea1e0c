"""PyTorch + CUDA port of tethys_tpu: Whisper serving, Whisper training and
Wav2Vec2 training (pretraining, CTC and classification heads) through the
job CLIs.

The JAX package ``tethys_tpu`` is the reference; this package mirrors its
module names.  Every Pallas kernel on those paths is a CUDA C++ kernel for
Hopper (``csrc/``), built with ``nvcc`` at first use; each has a plain
PyTorch version beside it, which runs for CPU tensors only.
"""
