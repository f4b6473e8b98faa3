"""phantomsdr_tpu_torch: the spectrum server's DSP engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The same server as ``phantomsdr_tpu`` -- a large 50%-overlap sliding
FFT over real/IQ samples, per-listener channelization and demodulation
(USB/LSB/AM/FM), an int8-dB waterfall pyramid and a websocket serving
edge wire-compatible with the reference frontend -- written against
PyTorch.  It imports neither JAX nor the JAX package.
"""

from .config import ServerConfig, load_config, config_from_dict  # noqa: F401
from .pipeline import HopPipeline, HopState, HopOutputs  # noqa: F401
from .ops.channelizer import (  # noqa: F401
    ChannelTable, MODE_USB, MODE_LSB, MODE_AM, MODE_FM,
)

__version__ = "0.1.0"
