"""Hand-written CUDA kernels of the port (sources under ``csrc/``)."""
