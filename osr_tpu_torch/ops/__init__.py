"""Device operations of the search step: query scatter, head scoring
(plain PyTorch and the CUDA kernels of ``csrc/``) and exact top-k."""
