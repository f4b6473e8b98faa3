"""Hand-written CUDA kernels for Hopper (sm_90a), one module each:
``waterfall`` (K-WF), ``pll`` (K-PLL), ``agc`` (K-AGC, with its float
output mode), ``pilot`` (K-PILOT) and ``deemph`` (K-DEEMPH).  Every module
holds the kernel's wrapper, its plain PyTorch version (taken only for
CPU tensors) and its launch counter; ``build`` compiles and loads the
sources in ``phantomsdr_tpu_torch/csrc``."""
