"""Hand-written sm_90a CUDA kernels, each beside its plain PyTorch
version. A wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises."""
