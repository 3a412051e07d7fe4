"""Hand-written CUDA kernels with their plain PyTorch versions (counterpart of ppmstereo_tpu/kernels)."""
