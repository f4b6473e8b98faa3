"""PyTorch port vs the JAX package: int8-dB quantization and the
waterfall pyramid -- the plain version of kernel K-WF against both the
JAX XLA formulation and the Pallas kernel it replaces (interpret mode),
on CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from phantomsdr_tpu.config import config_from_dict as jconfig
from phantomsdr_tpu.ops import quantize as jq
from phantomsdr_tpu.ops.pallas.waterfall import fused_waterfall_pyramid
from phantomsdr_tpu.pipeline import waterfall_from_spectra as jwf

from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.ops import quantize as q
from phantomsdr_tpu_torch.ops.cuda import waterfall as kwf
from phantomsdr_tpu_torch.pipeline import waterfall_from_spectra

PYRAMID_SHAPES = [
    (1 << 12, 3, 1 << 10),   # multi-tile, shallow
    (1 << 12, 13, 1 << 10),  # all levels incl. width-1, coarse tail
    (1 << 14, 5, 1 << 14),   # single tile
]


def assert_steps(got, want):
    """At most one int8 step, on fewer than 0.1% of bins (log2 rounding
    at truncation edges; tests/test_pallas_waterfall.py's bound)."""
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def power(b, r, seed):
    rng = np.random.default_rng(seed)
    p = (10.0 ** rng.uniform(-12, 0, size=(b, r))).astype(np.float32)
    p[0, :7] = 0.0  # zero-power bins -> -128
    return p


@pytest.mark.parametrize("r,levels,tile", PYRAMID_SHAPES)
def test_plain_pyramid_matches_jax_xla(r, levels, tile):
    p = power(3, r, r + levels)
    want = np.asarray(jq.pyramid_flat(
        jq.waterfall_pyramid(jnp.asarray(p), levels, 12)))
    got = q.pyramid_flat(q.waterfall_pyramid(torch.from_numpy(p), levels,
                                             12)).numpy()
    assert_steps(got, want)


@pytest.mark.parametrize("r,levels,tile", PYRAMID_SHAPES)
def test_plain_pyramid_matches_pallas_kernel(r, levels, tile):
    p = power(3, r, r + levels + 1)
    want = np.asarray(fused_waterfall_pyramid(
        jnp.asarray(p), levels, 12, tile=tile, interpret=True))
    got = q.pyramid_flat(q.waterfall_pyramid(torch.from_numpy(p), levels,
                                             12)).numpy()
    assert_steps(got, want)


def test_quantize_power_edges_match_jax():
    p = np.float32([0.0, -1.0, 1e-45, 1e-30, 1e-12, 0.5, 1.0, 3e38,
                    np.inf, np.nan])
    for off in (0, 12, 20):
        want = np.asarray(jq.quantize_power(jnp.asarray(p), off))
        got = q.quantize_power(torch.from_numpy(p), off).numpy()
        np.testing.assert_array_equal(got, want)


def test_level_offsets_match_jax():
    assert q.pyramid_level_offsets(1 << 20, 11) == jq.pyramid_level_offsets(
        1 << 20, 11)
    assert kwf.pyramid_width(1 << 20, 11) == 2_096_128


@pytest.mark.parametrize("signal", ["iq", "real"])
def test_waterfall_rows_match_jax_on_due_rows(signal):
    """The K-WF function (plain version on CPU): power + roll + pyramid
    read straight from the spectra rows, vs the JAX pipeline's
    waterfall_from_spectra on the gathered rows."""
    d = {"input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                   "signal": signal, "audio_sps": 12000,
                   "waterfall_size": 256, "driver": {"format": "s16"}},
         "tpu": {"hop_batch": 4, "max_channels": 16}}
    jc, tc = jconfig(d), config_from_dict(d)
    rng = np.random.default_rng(7)
    width = jc.fft_size // 2 + 1 if jc.is_real else jc.fft_size
    spec = ((rng.standard_normal((4, width))
             + 1j * rng.standard_normal((4, width)))
            * 10.0 ** rng.uniform(-6, -1, size=(4, width))).astype(np.complex64)
    rows = np.array([3, 0, 2], np.int32)
    want = np.asarray(jwf(jc, jnp.asarray(spec[rows])))
    got = waterfall_from_spectra(tc, torch.from_numpy(spec),
                                 torch.from_numpy(rows)).numpy()
    assert_steps(got, want)


def spectra(b, width, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, width))
             + 1j * rng.standard_normal((b, width)))
            * 10.0 ** rng.uniform(-6, -1, size=(b, width))).astype(np.complex64)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("r,levels,base_idx", [
    (1 << 12, 12, 777),             # an odd roll that is not N/2 + 1
    (1 << 11, 12, 3 * (1 << 11) + 5),   # past R, P odd
])
def test_plain_rows_match_jax_at_other_rolls(reference, r, levels, base_idx):
    """The K-WF function at a roll the configs do not give, against the
    JAX package's power + roll + pyramid (XLA, or the Pallas kernel in
    interpret mode)."""
    spec = spectra(4, r + 3, r + levels)
    rows = np.array([2, 0, 2], np.int32)
    pw = jq.roll_iq(jq.spectrum_power(jnp.asarray(spec[rows][:, :r])),
                    base_idx % r)
    want = np.asarray(
        jq.pyramid_flat(jq.waterfall_pyramid(pw, levels, 12))
        if reference == "xla" else
        fused_waterfall_pyramid(pw, levels, 12, tile=r, interpret=True))
    got = kwf.waterfall_rows_plain(
        torch.from_numpy(spec), torch.from_numpy(rows), fft_result_size=r,
        base_idx=base_idx, levels=levels, size_log2=12).numpy()
    assert_steps(got, want)


@pytest.mark.parametrize("signal", ["iq", "real"])
def test_waterfall_rows_match_jax_with_odd_pyramid_width(signal):
    """R = 512 down to one bin: P = 1023, odd (output rows misaligned on
    the card); real rows have 513 bins (odd row stride)."""
    d = {"input": {"sps": 192000, "frequency": 7000000,
                   "fft_size": 512 if signal == "iq" else 1024,
                   "signal": signal, "audio_sps": 12000,
                   "waterfall_size": 1, "driver": {"format": "s16"}},
         "tpu": {"hop_batch": 4, "max_channels": 16}}
    jc, tc = jconfig(d), config_from_dict(d)
    assert kwf.pyramid_width(tc.fft_result_size, tc.downsample_levels) == 1023
    width = jc.fft_size // 2 + 1 if jc.is_real else jc.fft_size
    spec = spectra(4, width, 11)
    rows = np.array([1, 3, 3, 0], np.int32)
    want = np.asarray(jwf(jc, jnp.asarray(spec[rows])))
    got = waterfall_from_spectra(tc, torch.from_numpy(spec),
                                 torch.from_numpy(rows)).numpy()
    assert_steps(got, want)


@pytest.mark.parametrize("r,levels,columns,plan", [
    (1 << 20, 11, 1 << 20, (2_096_128, 0)),     # bench: one chunk deep
    (1 << 11, 12, 1 << 11, (4095, 0)),          # every level in a chunk
    (1 << 12, 13, 4097, (8191, 4)),             # one level past a chunk
    (1 << 16, 17, 1 << 16, (131_071, 64)),
    (1 << 9, 10, 513, (1023, 0)),               # narrower than a chunk
])
def test_launch_plan(r, levels, columns, plan):
    assert kwf.launch_plan(r, levels, columns) == plan
    assert plan[0] == q.pyramid_level_offsets(r, levels)[-1] + (
        r >> (levels - 1))


@pytest.mark.parametrize("r,levels,columns", [
    (3 << 10, 2, 3 << 10), (1 << 12, 2, 4095), (1 << 12, 0, 1 << 12),
    (1 << 12, 14, 1 << 12),
])
def test_launch_plan_rejects(r, levels, columns):
    with pytest.raises(ValueError):
        kwf.launch_plan(r, levels, columns)


def test_waterfall_rows_rejects_other_devices():
    spec = torch.zeros((2, 64), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kwf.waterfall_rows(spec, torch.zeros(1, dtype=torch.int32),
                           fft_result_size=64, base_idx=0, levels=2,
                           size_log2=6)
