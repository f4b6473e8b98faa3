"""The benchmark of the PyTorch and CUDA port (``phantomsdr_tpu_torch``):
its driver fed fresh sample blocks at published deployments.

    python -m sdrbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations (``sdrbench/configs/``), traffic mixes
(``sdrbench/traffic/``) and metrics (``sdrbench/metrics/``); the plain
reference the outputs are held to is ``sdrbench/reference/``.
"""
