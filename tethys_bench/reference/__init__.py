"""Plain float32 PyTorch references of the steps the benchmark times.

They import nothing of the program under test, nor JAX: they are the
yardstick that decides ``correct``.
"""
