"""Hand-written Hopper kernels of the port, one package per TPU kernel of the
JAX package (``repro.kernels``), each with its plain PyTorch version beside
it.  A wrapper takes the plain version for a CPU tensor and launches its CUDA
kernel for a CUDA tensor; the sources are in ``repro_torch/csrc``."""
