"""The roofline counts reproduce the bounds PERF.md gives for the port's
kernels at the bench shapes (chip_smoke.py's arithmetic, published H100
peaks)."""

import pytest

from sdrbench import roofline


def ms(counts):
    return roofline.least_s(*counts)[0] * 1e3


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.FP32_FLOPS == 67e12
    assert roofline.BF16_FLOPS == 989e12


def test_waterfall_iq_rows():
    # K-WF on [36, 2^20] c64 spectra, 6 due rows, 11 levels
    assert ms(roofline.waterfall(6, 1 << 20, 11)) == pytest.approx(
        0.0188, abs=5e-5)
    assert roofline.least_s(*roofline.waterfall(6, 1 << 20, 11))[1] == \
        "bytes"


def test_waterfall_real_rows():
    # [96, 524,289] real-input spectra, 8 due rows, 10 levels
    assert ms(roofline.waterfall(8, 1 << 19, 10)) == pytest.approx(
        0.0125, abs=5e-5)


def test_pll():
    assert ms(roofline.am_pll(128, 6480)) == pytest.approx(0.00495,
                                                           abs=5e-6)


def test_agc():
    assert ms(roofline.agc(128, 6480, 2400)) == pytest.approx(0.00222,
                                                              abs=5e-6)


def _records(kept: int, launched: int):
    from sdrbench import trace
    from sdrbench.reference import dsp
    from sdrbench.tests.sdrbench_cells import REPO
    from sdrbench import spec

    cfg = spec.cell(REPO, "iq35.mixed128").server_config
    ops = []
    for i in range(kept):     # one step's kernels every 2 ms
        t = i * 2_000_000
        ops += [("agc_kernel", t, t + 70_000),
                ("tile_pyramid_kernel", t + 100_000, t + 130_000),
                ("pll_chain_kernel", t + 200_000, t + 1_500_000),
                ("pll_output_kernel", t + 1_500_000, t + 1_504_000)]
    rec = trace.Records(spans={}, steps=kept, device=ops,
                        window_ns=(0, max(kept, 1) * 2_000_000),
                        launches={"agc": launched, "waterfall": launched,
                                  "pll": launched})
    rec.plan = dsp.plan(cfg)
    rec.due_rows = 6
    return rec


@pytest.mark.parametrize("kept,launched,reported", [
    (100, 100, True), (100, 102, True), (100, 103, False), (0, 50, False)])
def test_device_figures_only_from_whole_records(kept, launched, reported):
    # where the profiler kept fewer records of the port's kernels than it
    # launched, no share and no idle figure is reported
    from sdrbench import spec
    from sdrbench.tests.sdrbench_cells import REPO

    rec = _records(kept, launched)
    names = ("waterfall_roofline", "am_pll_roofline", "agc_roofline",
             "device_idle_pct")
    mods = [spec.metric_module(REPO, n) for n in names]
    for mod in mods:
        if hasattr(mod, "PARTS"):
            rec.check_counts(mod.PARTS, mod.LAUNCHER)
    got = [mod.read(rec) for mod in mods]
    if reported:
        assert not rec.dropped
        assert all(v is not None and 0 < v < 100 for v in got)
        assert got[3] == pytest.approx(100 * (1 - 1.404 / 2), rel=1e-9)
    else:
        assert rec.dropped and got == [None] * 4
