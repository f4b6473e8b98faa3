"""PyTorch port vs the JAX package: FM de-emphasis (ops/deemph.py, the
plain version of kernel K-DEEMPH) over chained blocks, on CPU.

Tolerance: |diff| <= 2e-5 * max|x| (tests/test_deemph.py's atol 2e-5 at
unit scale): the port runs the recurrence sample by sample, JAX as an
associative scan, so the two round differently.  Rows with the mask
clear pass through bit for bit and keep their carry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.ops import deemph as jde

from phantomsdr_tpu_torch.ops import deemph as de

FS = 192000


@pytest.mark.parametrize("sps,tau", [(192000, 75.0), (48000, 50.0)])
def test_alpha_equals_jax(sps, tau):
    assert de.deemph_alpha(sps, tau) == jde.deemph_alpha(sps, tau)


@pytest.mark.parametrize("scale,blk", [(1.0, 4096), (300.0, 1001)])
def test_deemph_matches_jax_across_blocks(scale, blk):
    rng = np.random.default_rng(int(scale) + blk)
    a = de.deemph_alpha(FS, 75.0)
    rows = 6
    x = (rng.standard_normal((rows, 3 * blk)) * scale).astype(np.float32)
    mask = np.array([True, True, False, True, False, True])
    jy0 = (rng.standard_normal(rows) * scale).astype(np.float32)
    ty0 = torch.from_numpy(jy0.copy())
    jy0 = jnp.asarray(jy0)
    tol = 2e-5 * float(np.abs(x).max())
    for k in range(3):
        xb = x[:, k * blk:(k + 1) * blk]
        before = ty0.clone()
        jy0, jy = jde.deemph_process(jy0, a, jnp.asarray(xb),
                                     jnp.asarray(mask))
        ty0, ty = de.deemph_process(ty0, a, torch.from_numpy(xb),
                                    torch.from_numpy(mask))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tol,
                                   rtol=0)
        np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), atol=tol,
                                   rtol=0)
        # masked rows: passed through, carry kept
        np.testing.assert_array_equal(ty.numpy()[~mask], xb[~mask])
        np.testing.assert_array_equal(ty0.numpy()[~mask],
                                      before.numpy()[~mask])


def test_deemph_response_of_one_pole():
    """A 10 kHz tone comes out at the single-pole gain
    1/sqrt(1 + (2 pi f tau)^2) (within 2%; the discrete pole)."""
    a = de.deemph_alpha(FS, 75.0)
    t = np.arange(FS // 4) / FS
    x = np.sin(2 * np.pi * 10000 * t).astype(np.float32)[None]
    _, y = de.deemph_process(torch.zeros(1), a, torch.from_numpy(x),
                             torch.ones(1, dtype=torch.bool))
    y = y.numpy()[0, FS // 8:]
    want = 1 / np.sqrt(1 + (2 * np.pi * 10000 * 75e-6) ** 2)
    assert abs(np.sqrt(2) * y.std() / want - 1) < 0.02


def test_agc_float_on_cpu_is_agc_process():
    """K-AGC's float mode takes agc_process for CPU tensors."""
    from phantomsdr_tpu_torch.ops.agc import (
        agc_process, init_agc_state, make_agc_params,
    )
    from phantomsdr_tpu_torch.ops.cuda.agc import agc_float

    params = make_agc_params(2000)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 900)).astype(np.float32))
    st = init_agc_state(3, params.window)
    (s1, y1), (s2, y2) = agc_float(st, x, params), agc_process(st, x, params)
    assert torch.equal(y1, y2) and torch.equal(s1.gain, s2.gain)
