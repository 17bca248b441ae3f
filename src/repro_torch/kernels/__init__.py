"""Hand-written CUDA kernels of the port (``csrc/``), their builds
(``build.py``) and their Python wrappers with plain PyTorch twins."""

# dynamic shared memory one block may claim on an H100 (227 KB)
SMEM_PER_BLOCK = 232_448
