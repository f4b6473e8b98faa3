"""PyTorch port vs the JAX package: wire-format conversion, framing and
the forward spectrum (CPU, plain PyTorch)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from phantomsdr_tpu.ops import convert as jconvert
from phantomsdr_tpu.ops import fft as jfft
from phantomsdr_tpu.ops.windows import hann_window as jhann
from phantomsdr_tpu.config import config_from_dict as jconfig
from phantomsdr_tpu.pipeline import spectra_from_raw as jspectra

from phantomsdr_tpu_torch.ops import convert, fft
from phantomsdr_tpu_torch.ops.windows import hann_window
from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.pipeline import spectra_from_raw

FORMATS = ["u8", "s8", "u16", "s16", "u32", "s32", "f32", "f64"]


def wire_samples(fmt, n, seed):
    r = np.random.default_rng(seed)
    d = convert.wire_dtype(fmt)
    if d.kind in "ui":
        info = np.iinfo(d)
        raw = r.integers(info.min, info.max, size=n, endpoint=True, dtype=d)
        raw[:4] = [info.min, info.max, (info.min + info.max) // 2,
                   (info.min + info.max) // 2 + 1]
        return raw
    return r.standard_normal(n).astype(d)


@pytest.mark.parametrize("fmt", FORMATS)
def test_to_float_matches_jax(fmt):
    raw = wire_samples(fmt, 4096, 11)
    want = np.asarray(jconvert.to_float(
        jnp.asarray(jconvert.host_preconvert(raw, fmt)), fmt))
    got = convert.to_float(
        torch.from_numpy(convert.host_preconvert(raw, fmt)), fmt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_u32_recentres_in_the_integer_domain():
    # 0x80000001 must become 2^-31, not 0 (a float32 cast before the
    # subtract would round it away)
    raw = np.array([0x80000001, 0x80000000, 0x7FFFFFFF], np.uint32)
    got = convert.to_float(
        torch.from_numpy(convert.host_preconvert(raw, "u32")), "u32").numpy()
    np.testing.assert_array_equal(got, np.float32([2.0 ** -31, 0.0, -2.0 ** -31]))


def test_iq_to_complex_is_a_view():
    x = torch.arange(8, dtype=torch.float32)
    z = convert.iq_to_complex(x)
    np.testing.assert_array_equal(z.numpy(), [0 + 1j, 2 + 3j, 4 + 5j, 6 + 7j])
    assert z.data_ptr() == x.data_ptr()


def test_frame_hops_matches_jax():
    n, b = 64, 3
    s = np.arange((b + 1) * n // 2, dtype=np.float32)
    t = torch.from_numpy(s)
    got = fft.frame_hops(t, b, n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfft.frame_hops(jnp.asarray(s), b, n)))
    # a strided view over the input, not a copy
    assert got.data_ptr() == t.data_ptr() and got.stride() == (n // 2, 1)


@pytest.mark.parametrize("is_real", [False, True])
def test_forward_spectrum_matches_jax(is_real):
    r = np.random.default_rng(5)
    n = 4096
    w = hann_window(n)
    np.testing.assert_array_equal(w, np.asarray(jhann(n)))
    if is_real:
        frames = r.standard_normal((3, n)).astype(np.float32)
    else:
        frames = (r.standard_normal((3, n))
                  + 1j * r.standard_normal((3, n))).astype(np.complex64)
    want = np.asarray(jfft.forward_spectrum(jnp.asarray(frames), w, is_real,
                                            "direct"))
    got = fft.forward_spectrum(torch.from_numpy(frames),
                               torch.from_numpy(w), is_real).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("fmt,signal", [("s16", "iq"), ("u8", "iq"),
                                        ("s16", "real")])
def test_spectra_from_raw_matches_jax(fmt, signal):
    d = {"input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                   "signal": signal, "audio_sps": 12000,
                   "waterfall_size": 512, "driver": {"format": fmt}},
         "tpu": {"hop_batch": 4, "max_channels": 16}}
    jc, tc = jconfig(d), config_from_dict(d)
    wire = (jc.hop_batch + 1) * jc.hop_size * (1 if jc.is_real else 2)
    raw = wire_samples(fmt, wire, 3)
    want = np.asarray(jspectra(jc, jhann(jc.fft_size),
                               jnp.asarray(jconvert.host_preconvert(raw, fmt)),
                               jc.hop_batch))
    got = spectra_from_raw(tc, torch.from_numpy(hann_window(tc.fft_size)),
                           torch.from_numpy(convert.host_preconvert(raw, fmt)),
                           tc.hop_batch).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
