"""The hop step replayed as a captured CUDA graph (``step_graph``).

On the CPU, through a stand-in capture (the body runs at capture and at
every replay, its fresh outputs copied into the first ones' tensors, as
a graph writes its own buffers): which inputs make another graph key
and which do not, that a reset step, a 'full' step and a variant's
first step run eagerly, that a state the last replay did not return is
copied in, that a failed capture leaves its key eager, the crediting of
each kernel's ``launches``, the driver's ``graph_steps``,
``eager_steps`` and ``graph_captures``, and every step bit-equal to the
eager pipeline.

On the card (marked ``cuda``, skipped elsewhere): 24 steps of a mixed
USB/LSB/AM(PLL)/FM table with views (IQ and real input), the waterfall
modes alternating,
one step with a reset mask, one change of table and one fresh state
from the caller, eagerly and with replay, ``packed`` and every carry
bit-equal at every step and the kernels' launch totals equal; the same
for a WBFM stereo + RDS config and each noise processor; and
torch.profiler's records of the replayed kernels, by name, against the
credited launches.  Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py
"""

import io
import time

import numpy as np
import pytest
import torch

from phantomsdr_tpu_torch.config import config_from_dict
from phantomsdr_tpu_torch.ops.cuda import all_kernels
from phantomsdr_tpu_torch.pipeline import (
    HopPipeline, WaterfallViews, channels_from_numpy,
)
from phantomsdr_tpu_torch.runtime.driver import Metrics
from phantomsdr_tpu_torch.runtime.registry import RESET_AGC, RESET_FULL
from phantomsdr_tpu_torch.step_graph import StepGraphs, flat_tensors

STEPS = 24
RESET_STEP, TABLE_STEP, FRESH_STEP = 5, 12, 17


def iq_dict(signal="iq", **extra):
    return {
        "input": {"sps": 192000, "frequency": 7000000, "fft_size": 4096,
                  "signal": signal, "audio_sps": 12000,
                  "waterfall_size": 512, "driver": {"format": "s16"},
                  **extra},
        "tpu": {"hop_batch": 4, "max_channels": 16},
    }


def wbfm_dict():
    return {
        "input": {"sps": 1_536_000, "frequency": 98_000_000,
                  "fft_size": 32768, "signal": "iq", "audio_sps": 192000,
                  "waterfall_size": 512, "stereo": True, "rds": True,
                  "deemphasis": 75, "audio_compression": "opus",
                  "driver": {"format": "s16"}},
        "tpu": {"hop_batch": 4, "max_channels": 4},
    }


def table(cfg, device, k=None, shift=0, **over):
    """USB/LSB/AM/FM cycling over the rows (one AM row on its envelope,
    the last row idle), ``shift`` bins higher; ``over`` replaces columns
    (numpy arrays of the full width)."""
    c = cfg.max_channels
    l = np.linspace(10, cfg.fft_result_size - 300, c).astype(np.int32) + shift
    am_env = np.zeros(c, bool)
    am_env[min(6, c - 1)] = True
    active = np.ones(c, bool)
    active[-1] = False
    cols = dict(l=l, r=l + 100, m_idx=l + 50, mode=np.arange(c) % 4,
                active=active, am_env=am_env, **over)
    if k is not None:
        cols = {key: v[:k] for key, v in cols.items()}
    return channels_from_numpy(**cols, device=device)


def wbfm_table(cfg, device, rds=(True, False, False, True)):
    mid, half = cfg.fft_result_size // 2, cfg.audio_fft_size // 2
    return channels_from_numpy(
        [mid - half // 2] * 4, [mid + half // 2] * 4, [mid] * 4,
        [3, 3, 0, 3], [True, True, True, False], rds=list(rds),
        device=device)


def views_for(pipe, w=4):
    start = np.array([100, 3000, 5000, 0, 40, 900][:w], np.int32)
    length = np.array([512, 300, 256, 0, 64, 128][:w], np.int32)
    return WaterfallViews(start=torch.from_numpy(start).to(pipe.device),
                          length=torch.from_numpy(length).to(pipe.device))


def blocks(cfg, n, seed=7):
    """n halo'd s16 blocks of one continuous stream (two tones, noise,
    rare impulses for the noise blanker)."""
    wph = cfg.hop_size * (1 if cfg.is_real else 2)
    blk = cfg.hop_batch * wph
    rng = np.random.default_rng(seed)
    t = np.arange(n * blk + wph)
    x = (rng.integers(-3000, 3000, t.size) + 8000 * np.sin(0.13 * t)
         + 5000 * np.sin(2.331 * t)
         + 20000 * (rng.random(t.size) < 0.002)).astype(np.int16)
    return [x[s * blk: s * blk + blk + wph] for s in range(n)]


def stub_capture(kernels=()):
    """A capture for the CPU: the body runs at capture and again at each
    replay, its fresh outputs copied into the tensors it returned first;
    a replay takes back the launches its body's wrappers counted, as a
    graph's replay calls no wrapper."""
    def capture(body):
        out = body()

        def replay():
            before = [k.launches for k in kernels]
            new = body()
            for k, n in zip(kernels, before):
                k.launches = n
            for a, b in zip(flat_tensors(out), flat_tensors(new)):
                a.copy_(b)
        return out, replay
    return capture


def with_stub(pipe, kernels=(), eager=None):
    pipe.graphs = StepGraphs(eager or pipe._eager_step, pipe.hop_batch,
                             list(kernels), stub_capture(kernels))
    return pipe


def snapshot(state, out):
    return (out.packed.cpu().clone(),
            [t.cpu().clone() for t in flat_tensors(state.audio)])


def run(pipe, cfg, tables, views, raws, reset_step=RESET_STEP,
        fresh_step=FRESH_STEP, table_step=TABLE_STEP):
    """The step sequence both sides run: modes alternating views/off,
    frame0's due rows, a reset mask at ``reset_step``, the second table
    from ``table_step``, the caller's fresh state at ``fresh_step``.
    Returns each step's (packed, carries) and whether it was a replay."""
    dev = pipe.device
    reset = np.zeros(tables[0].l.shape[0], np.int32)
    reset[1], reset[2] = RESET_FULL, RESET_AGC
    reset = torch.from_numpy(reset).to(dev)
    state = pipe.init_state()
    got, replayed = [], []
    for s, raw in enumerate(raws):
        frame0 = s * cfg.hop_batch
        if s == fresh_step:
            state = pipe.init_state(frame0)
        state, out = pipe.step(
            state, torch.from_numpy(raw).to(dev),
            tables[s >= table_step], views,
            "views" if s % 2 == 0 else "off",
            reset=reset if s == reset_step else None,
            due_idx=pipe.default_due_idx(frame0))
        got.append(snapshot(state, out))
        replayed.append(pipe.last_step_replayed)
    return got, replayed


def assert_bit_equal(a, b):
    for s, ((pa, ca), (pb, cb)) in enumerate(zip(a, b)):
        assert torch.equal(pa, pb), f"step {s}: packed differs"
        assert len(ca) == len(cb)
        for i, (x, y) in enumerate(zip(ca, cb)):
            assert torch.equal(x, y), f"step {s}: carry {i} differs"


# ------------------------------------------------------------------ CPU

@pytest.fixture(scope="module")
def cpu():
    cfg = config_from_dict(iq_dict())
    pipe = HopPipeline(cfg, device="cpu")
    return cfg, pipe


@pytest.fixture(params=["iq", "real"])
def signal(request):
    return request.param


KEY_CASES = {
    # name: (changes the key, how)
    "bucket": (True, lambda a: {**a, "chans": a["narrow"]}),
    "view_width": (True, lambda a: {**a, "views": a["views2"]}),
    "waterfall_mode": (True, lambda a: {**a, "waterfall": "off"}),
    "need_pll": (True, lambda a: {**a, "chans": a["chans"]._replace(
        need_pll=not a["chans"].need_pll)}),
    "need_rds": (True, lambda a: {**a, "chans": a["chans"]._replace(
        need_rds=True)}),
    "need_nr": (True, lambda a: {**a, "chans": a["chans"]._replace(
        need_nr=True)}),
    "parity": (True, lambda a: {**a, "state": a["state"]._replace(
        frame=1)}),
    "raw_length": (True, lambda a: {**a, "raw": a["raw"][:-2]}),
    "raw_dtype": (True, lambda a: {**a, "raw": a["raw"].to(torch.int32)}),
    "frame_same_parity": (False, lambda a: {**a, "state": a["state"]._replace(
        frame=6)}),
    "table_contents": (False, lambda a: {**a, "chans": a["shifted"]}),
    "view_contents": (False, lambda a: {**a, "views": a["views_moved"]}),
    "carry_values": (False, lambda a: {**a, "state": a["state"]._replace(
        audio=a["warm"])}),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_graph_key_follows_variant_not_values(cpu, case):
    cfg, pipe = cpu
    views = views_for(pipe)
    base = {"state": pipe.init_state(),
            "raw": torch.from_numpy(blocks(cfg, 1)[0]),
            "chans": table(cfg, "cpu"), "views": views,
            "waterfall": "views"}
    extra = {"narrow": table(cfg, "cpu", k=8), "views2": views_for(pipe, 2),
             "shifted": table(cfg, "cpu", shift=40),
             "views_moved": views._replace(start=views.start + 7),
             "warm": pipe.init_state().audio._replace(
                 de=torch.ones_like(base["state"].audio.de))}
    changes, how = KEY_CASES[case]
    other = how({**base, **extra})
    keys = [StepGraphs.key(**{k: a[k] for k in base}) for a in (base, other)]
    assert (keys[0] != keys[1]) is changes


def test_replay_bit_equal_to_eager_and_counted(signal):
    """The card test's sequence through the stand-in capture: every step
    bit-equal; the first step of each mode and the reset step eager,
    every other step a replay of one of two graphs, whichever due rows,
    table or state it was given."""
    cfg = config_from_dict(iq_dict(signal))
    raws = blocks(cfg, 12)
    sides = []
    for graphs in (False, True):
        pipe = HopPipeline(cfg, device="cpu")
        if graphs:
            with_stub(pipe)
        tables = (table(cfg, "cpu"), table(cfg, "cpu", shift=40))
        sides.append(run(pipe, cfg, tables, views_for(pipe), raws,
                         reset_step=3, table_step=6, fresh_step=8))
    assert_bit_equal(sides[0][0], sides[1][0])
    assert not any(sides[0][1])
    assert sides[1][1] == [s not in (0, 1, 3) for s in range(12)]
    assert pipe.graphs.captures == 2 and not pipe.graphs.failed


def test_reset_full_and_first_steps_run_eagerly(cpu):
    cfg, _ = cpu
    pipe = with_stub(HopPipeline(cfg, device="cpu"))
    raw = torch.from_numpy(blocks(cfg, 1)[0])
    chans = table(cfg, "cpu")
    st = pipe.init_state()
    st, _ = pipe.step(st, raw, chans, waterfall="off")
    assert not pipe.last_step_replayed and pipe.graphs.captures == 1
    st, _ = pipe.step(st, raw, chans, waterfall="off")
    assert pipe.last_step_replayed
    reset = torch.full((cfg.max_channels,), RESET_FULL, dtype=torch.int32)
    st, _ = pipe.step(st, raw, chans, waterfall="off", reset=reset)
    assert not pipe.last_step_replayed
    st, _ = pipe.step(st, raw, chans, waterfall="full")
    assert not pipe.last_step_replayed
    st, _ = pipe.step(st, raw, chans._replace(need_rds=True),
                      waterfall="off")          # a key first seen now
    assert not pipe.last_step_replayed and pipe.graphs.captures == 2
    st, _ = pipe.step(st, raw, chans, waterfall="off")
    assert pipe.last_step_replayed and pipe.graphs.captures == 2


def test_foreign_state_is_copied_in(cpu):
    """After replays, a fresh state passed twice (the same object) and a
    state shrunk to the bucket each start from their own values."""
    cfg, _ = cpu
    raws = [torch.from_numpy(b) for b in blocks(cfg, 6)]
    chans = table(cfg, "cpu")
    eager = HopPipeline(cfg, device="cpu")
    pipe = with_stub(HopPipeline(cfg, device="cpu"))
    st = pipe.init_state()
    for raw in raws[:3]:
        st, _ = pipe.step(st, raw, chans, waterfall="off")
    fresh = pipe.init_state(8)
    want = snapshot(*eager.step(fresh, raws[3], chans, waterfall="off"))
    for _ in range(2):
        got = snapshot(*pipe.step(fresh, raws[3], chans, waterfall="off"))
        assert pipe.last_step_replayed
        assert_bit_equal([want], [got])
    # the bucket: a state and table of 8 rows
    small = table(cfg, "cpu", k=8)
    st8 = eager.resize_channel_rows(eager.init_state(), 8)
    want = snapshot(*eager.step(st8, raws[4], small, waterfall="off"))
    pipe.step(pipe.resize_channel_rows(pipe.init_state(), 8), raws[4],
              small, waterfall="off")          # first sight: captures
    got = snapshot(*pipe.step(pipe.resize_channel_rows(pipe.init_state(),
                                                       8),
                              raws[4], small, waterfall="off"))
    assert pipe.last_step_replayed
    assert_bit_equal([want], [got])


def test_failed_capture_leaves_the_key_eager(cpu):
    cfg, _ = cpu
    pipe = HopPipeline(cfg, device="cpu")
    calls = []

    def refuse(body):
        calls.append(1)
        body()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    kernel = Counter()

    def eager(*a):
        kernel.launches += 2
        return pipe._eager_step(*a)
    pipe.graphs = StepGraphs(eager, cfg.hop_batch, [kernel], refuse)
    raw = torch.from_numpy(blocks(cfg, 1)[0])
    st = pipe.init_state()
    for _ in range(3):
        st, _ = pipe.step(st, raw, table(cfg, "cpu"), waterfall="off")
        assert not pipe.last_step_replayed
    assert len(calls) == 1 and pipe.graphs.captures == 0
    assert "not permitted" in next(iter(pipe.graphs.failed.values()))
    assert kernel.launches == 3 * 2      # the failed capture's taken back


class Counter:
    """A kernel's launch counter (``ops.cuda.build.CudaKernel``'s)."""

    def __init__(self):
        self.launches = 0


@pytest.mark.parametrize("per_step", [1, 3])
def test_replays_credit_the_launches_their_capture_recorded(cpu, per_step):
    """A wrapper counts per_step launches a step; the capture's own count
    is taken back and each replay credits what the capture recorded, so
    after n steps the counter reads n * per_step, as eagerly."""
    cfg, _ = cpu
    pipe = HopPipeline(cfg, device="cpu")
    kernel, idle = Counter(), Counter()

    def eager(*a):
        kernel.launches += per_step
        return pipe._eager_step(*a)
    with_stub(pipe, [kernel, idle], eager)
    raw = torch.from_numpy(blocks(cfg, 1)[0])
    st = pipe.init_state()
    for n in range(1, 6):
        st, _ = pipe.step(st, raw, table(cfg, "cpu"), waterfall="off")
        assert kernel.launches == n * per_step
    (graph,) = pipe.graphs.graphs.values()
    assert graph.credits == ((kernel, per_step),) and idle.launches == 0


def test_metrics_snapshot_reports_graph_counters():
    m = Metrics(graph_steps=5, eager_steps=2, graph_captures=4)
    snap = m.snapshot(config_from_dict(iq_dict()))
    assert (snap["graph_steps"], snap["eager_steps"],
            snap["graph_captures"]) == (5, 2, 4)


@pytest.mark.parametrize("replay", [False, True])
def test_driver_counts_replayed_and_eager_steps(replay):
    """DSPDriver on the CPU: eager throughout; with a stand-in capture,
    the warm-up captures both waterfall modes with the AM PLL off and on
    at each bucket, and every served step is a replay (the warm-up's
    snapshot took the listeners' one-shot reset mask)."""
    from phantomsdr_tpu_torch.runtime.driver import DSPDriver, SampleSource
    from phantomsdr_tpu_torch.runtime.registry import ChannelRegistry

    d = iq_dict()
    d["tpu"]["channel_bucket"] = 8
    cfg = config_from_dict(d)
    n = 4
    raw = np.concatenate([b[cfg.hop_size * 2:] for b in blocks(cfg, n)])
    channels = ChannelRegistry(cfg)
    for i in range(3):
        slot = channels.acquire(f"l{i}")
        channels.retune(slot, 100 + 200 * i, 150.0 + 200 * i,
                        200 + 200 * i)
        channels.set_mode(slot, ("USB", "AM", "FM")[i])
    got = []
    driver = DSPDriver(cfg, SampleSource(cfg, io.BytesIO(raw.tobytes())),
                       channels, lambda *a: got.append(a),
                       waterfall_active=lambda: False, device="cpu")
    if replay:
        with_stub(driver.pipe)
    driver.start()
    t0 = time.monotonic()
    while len(got) < n and time.monotonic() - t0 < 120:
        time.sleep(0.05)
    driver.stop()
    snap = driver.metrics.snapshot(cfg)
    assert len(got) == n and snap["device_errors"] == 0
    if replay:
        assert (snap["graph_steps"], snap["eager_steps"],
                snap["graph_captures"]) == (n, 0, 8)
    else:
        assert (snap["graph_steps"], snap["eager_steps"],
                snap["graph_captures"]) == (0, n, 0)


# ----------------------------------------------------------------- card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the step's graphs are CUDA "
                    "graphs)")
    return "cuda"


def card_sides(cfg, make_tables, n=STEPS):
    """``run`` eagerly and with replay on the card; each side's kernel
    launch totals beside its steps."""
    raws = blocks(cfg, n)
    kernels = all_kernels()
    sides = []
    for graphs in (False, True):
        pipe = HopPipeline(cfg, device="cuda")
        if not graphs:
            pipe.graphs = None
        for k in kernels:
            k.launches = 0
        got, replayed = run(pipe, cfg, make_tables(pipe),
                            views_for(pipe), raws)
        torch.cuda.synchronize()
        sides.append((got, replayed, {k.name: k.launches for k in kernels},
                      pipe))
    return sides


def check_card(sides, n=STEPS):
    (ge, re_, le, _), (gg, rg, lg, pipe) = sides
    assert_bit_equal(ge, gg)
    assert le == lg and sum(le.values()) > 0
    assert not any(re_)
    assert rg == [s not in (0, 1, RESET_STEP) for s in range(n)], \
        pipe.graphs.failed
    assert pipe.graphs.captures == 2 and not pipe.graphs.failed


@pytest.mark.cuda
def test_card_replay_bit_equal_mixed_table(dev, signal):
    cfg = config_from_dict(iq_dict(signal))
    sides = card_sides(cfg, lambda p: (table(cfg, dev),
                                       table(cfg, dev, shift=40)))
    check_card(sides)
    assert sides[1][2]["pll"] > 0 and sides[1][2]["waterfall"] > 0


@pytest.mark.cuda
def test_card_replay_bit_equal_wbfm_stereo_rds(dev):
    cfg = config_from_dict(wbfm_dict())
    sides = card_sides(cfg, lambda p: (
        wbfm_table(cfg, dev), wbfm_table(cfg, dev, (True, True, False,
                                                    True))))
    check_card(sides)
    assert sides[1][2]["pilot"] > 0 and sides[1][2]["deemph"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["spectral", "lms", "notch", "nb"])
def test_card_replay_bit_equal_nr(dev, algo):
    cfg = config_from_dict(iq_dict(nr=True, nr_algo=algo))
    opted = np.arange(cfg.max_channels) % 2 == 0
    sides = card_sides(cfg, lambda p: (table(cfg, dev, nr=opted),
                                       table(cfg, dev, shift=40, nr=opted)))
    check_card(sides)


@pytest.mark.cuda
def test_card_profiler_records_replayed_kernels(dev):
    """torch.profiler keeps each replayed hand-written kernel under its
    own name, as many times as the replays credited its launches."""
    from torch.profiler import ProfilerActivity, profile

    cfg = config_from_dict(iq_dict())
    pipe = HopPipeline(cfg, device="cuda")
    chans, views = table(cfg, dev), views_for(pipe)
    raws = [torch.from_numpy(b).to(dev) for b in blocks(cfg, 6)]
    st = pipe.init_state()
    st, _ = pipe.step(st, raws[0], chans, views)      # eager, captures
    kernels = all_kernels()
    torch.cuda.synchronize()
    before = {k.name: k.launches for k in kernels}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for raw in raws[1:]:
            st, _ = pipe.step(st, raw, chans, views)
            assert pipe.last_step_replayed
        torch.cuda.synchronize()
    credited = {k.name: k.launches - before[k.name] for k in kernels}
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if str(ev.device_type()).endswith("CUDA")]

    def count(*parts):
        return sum(any(p in n for p in parts) for n in names)
    assert credited["pll"] == credited["agc"] == credited["waterfall"] == 5
    assert count("pll_chain_kernel") == credited["pll"]
    assert count("agc_kernel") == credited["agc"]
    assert count("chunk_pyramid_kernel",
                 "tile_pyramid_kernel") == credited["waterfall"]
