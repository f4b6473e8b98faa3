"""Hand-written CUDA kernels for Hopper (sm_90a), one module each:
``waterfall`` (K-WF), ``pll`` (K-PLL), ``agc`` (K-AGC, with its float
output mode), ``pilot`` (K-PILOT), ``deemph`` (K-DEEMPH), ``nr`` (K-NR),
``anr`` (K-ANR) and ``nb`` (K-NB, two launchers).  Every module holds
the kernel's wrapper, its plain PyTorch version (taken only for CPU
tensors) and its launch counter; ``build`` compiles and loads the
sources in ``phantomsdr_tpu_torch/csrc``."""


def all_kernels() -> list:
    """Every launcher of the package, to build them all at once."""
    from . import agc, anr, deemph, nb, nr, pilot, pll, waterfall

    return [waterfall.KERNEL, pll.KERNEL, agc.KERNEL, agc.FLOAT_KERNEL,
            pilot.KERNEL, deemph.KERNEL, nr.KERNEL, anr.KERNEL,
            nb.LPC_KERNEL, nb.REPAIR_KERNEL]
