"""PyTorch port vs the JAX package: the polyphase decimating FIR
(ops/polyphase.py) -- the taps, and the streaming decimation over
chained blocks with the filter tail carried -- on CPU.

Tolerance: atol 1e-5 at unit scale (tests/test_polyphase.py's bound
against its offline oracle; the two convolutions sum in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantomsdr_tpu.ops import polyphase as jpp

from phantomsdr_tpu_torch.ops import polyphase as pp


@pytest.mark.parametrize("num_taps,cutoff", [(64, 0.2), (48, 0.2), (397, 2 * 3200 / 192000)])
def test_taps_equal_the_jax_design(num_taps, cutoff):
    np.testing.assert_array_equal(pp.design_lowpass(num_taps, cutoff),
                                  jpp.design_lowpass(num_taps, cutoff))


@pytest.mark.parametrize("factor,tpp", [(4, 12), (2, 8), (32, 8)])
def test_decimator_taps_equal(factor, tpp):
    np.testing.assert_array_equal(pp.decimator_taps(factor, tpp),
                                  jpp.decimator_taps(factor, tpp))


@pytest.mark.parametrize("factor,blk", [(4, 512), (4, 1000), (32, 2048)])
def test_streaming_decimate_matches_jax(factor, blk):
    rng = np.random.default_rng(factor + blk)
    c = 5
    taps = pp.decimator_taps(factor, 12)
    nt = taps.shape[0]
    x = rng.standard_normal((c, 4 * blk)).astype(np.float32)
    js = jpp.init_decimator_state(c, nt)
    ts = pp.init_decimator_state(c, nt)
    for k in range(4):
        xb = x[:, k * blk:(k + 1) * blk]
        js, jy = jpp.polyphase_decimate(js, jnp.asarray(xb), taps, factor)
        ts, ty = pp.polyphase_decimate(ts, torch.from_numpy(xb), taps,
                                       factor)
        assert ty.shape == (c, blk // factor)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))


def test_block_not_a_multiple_of_the_factor_is_refused():
    taps = pp.decimator_taps(4)
    st = pp.init_decimator_state(1, taps.shape[0])
    with pytest.raises(ValueError, match="multiple"):
        pp.polyphase_decimate(st, torch.zeros(1, 10), taps, 4)


def test_fir_restores_the_tf32_setting():
    prev = torch.backends.cudnn.allow_tf32
    pp.fir(torch.ones(2, 40), pp.design_lowpass(9, 0.5))
    assert torch.backends.cudnn.allow_tf32 == prev
