"""Hand-written CUDA kernels for Hopper (sm_90a), one module each:
``waterfall`` (K-WF), ``pll`` (K-PLL) and ``agc`` (K-AGC).  Every module
holds the kernel's wrapper, its plain PyTorch version (taken only for
CPU tensors) and its launch counter; ``build`` compiles and loads the
sources in ``phantomsdr_tpu_torch/csrc``."""
