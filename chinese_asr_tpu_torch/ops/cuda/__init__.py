"""Hand-written CUDA kernels of the port (sources in ``csrc/``), one module
per TPU kernel they replace, each with its plain PyTorch twin and a launch
counter.  The wrappers take the twin only for CPU tensors; a CUDA tensor
launches the kernel or raises."""
