"""The harness driven end to end on the CPU at a tiny size: the port's
``DSPDriver`` with ``device="cpu"`` (its plain versions), fed by the ring
source, its outputs held to the reference.  A sound run comes out
correct; the control (the reference in bfloat16 in the program's
place) and each fault the cells can have (a step that hands on its
carries unchanged, half of the listeners left out, an answer altered
where it is produced) come out not correct.  The command refuses to run
without a card and in a directory holding only the benchmark."""

import json
import shutil
import subprocess
import sys
import time

import pytest

import sdrbench_cells
from sdrbench import harness

REPO = sdrbench_cells.REPO
CELLS = ("tiny.mixed", "tiny.ssb")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return sdrbench_cells.make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, **kw):
    kw.setdefault("seconds", 1.2)
    return harness.run(cell, kw.pop("seed", 2**31 + 17), kw.pop("seconds"),
                       kw.pop("trace", False), root=root, device="cpu",
                       t_process=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell, capsys):
    out = run(root, cell, seed=2**31 + 99)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"msps", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"audio_lsb", "power_rel", "wf_bytes",
                                  "steps_missing"}
    err = capsys.readouterr().err.strip().splitlines()
    assert [ln.split()[1] for ln in err[-4:]] == list(out["checks"])


def test_traced_run_reads_its_spans(root):
    out = run(root, "tiny.mixed", trace=True)
    assert out["correct"]
    # no card: no device figures, the host spans and latencies only
    assert set(out["metrics"]) == {"latency_p95_ms", "ingest_ms",
                                   "fetch_wait_ms", "step_issue_ms"}
    assert out["metrics"]["step_issue_ms"]["value"] > 0
    assert out["metrics"]["latency_p95_ms"]["value"] > 0


def _wrap(drv, edit):
    step = drv.pipe.step

    def broken(state, raw, *a, **kw):
        new, out = step(state, raw, *a, **kw)
        return edit(state, new, out)
    drv.pipe.step = broken


def state_unchanged(drv):
    _wrap(drv, lambda old, new, out: (old, out))


def half_left_out(drv):
    def edit(old, new, out):
        out.audio[:, out.audio.shape[1] // 2:] = 0
        out.avg_power[:, out.avg_power.shape[1] // 2:] = 0
        return new, out
    _wrap(drv, edit)


def audio_altered(drv):
    def edit(old, new, out):
        out.audio[1, 3, 5] += 700
        return new, out
    _wrap(drv, edit)


def view_altered(drv):
    def edit(old, new, out):       # one client's row of one due hop
        if out.wf.numel():
            out.wf[0, 2] += 9
        return new, out
    _wrap(drv, edit)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   audio_altered, view_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, cell, fault):
    out = run(root, cell, fault=fault)
    assert not out["correct"] and out["failed"] >= 1


def _write_into(old, new) -> int:
    """Copies ``new``'s tensors into ``old``'s, in place; the count."""
    import torch

    if isinstance(old, torch.Tensor):
        old.copy_(new)
        return 1
    if isinstance(old, (tuple, list)):
        return sum(_write_into(a, b) for a, b in zip(old, new))
    return 0


def carries_in_place(drv):
    # a sound program that writes its new carries over the old ones
    def edit(old, new, out):
        assert _write_into(old.audio, new.audio) > 0
        return new._replace(audio=old.audio), out
    _wrap(drv, edit)


def test_carries_written_in_place_are_judged_alike(root):
    # the comparison copies the carries going into a sampled step, so a
    # step that updates them in place is no fault
    out = run(root, "tiny.mixed", fault=carries_in_place)
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    out = run(root, cell, control=True)
    assert not out["correct"]
    c = out["checks"]
    # it fails by power and views as well as audio
    assert c["power_rel"]["value"] > c["power_rel"]["limit"]
    assert c["wf_bytes"]["value"] > c["wf_bytes"]["limit"]


def test_same_seed_same_ring(root):
    from sdrbench import spec, traffic
    from sdrbench.reference import dsp

    c = spec.cell(root, "tiny.mixed")
    p = dsp.plan(c.server_config)
    t = traffic.listener_table(p, c.mix)
    a = traffic.make_ring(p, c.mix, t, 2**33 + 5, "cpu")
    b = traffic.make_ring(p, c.mix, t, 2**33 + 5, "cpu")
    d = traffic.make_ring(p, c.mix, t, 2**33 + 6, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    assert not all((x == y).all() for x, y in zip(a, d))
    # continuous round the ring: each block's halo is the last hop before
    wph = p.wire_per_hop
    for j, blk in enumerate(a):
        prev = a[j - 1]
        assert (blk[:wph] == prev[-wph:]).all()
        assert blk.flags.c_contiguous and blk.flags.writeable


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "sdrbench", "--workload", "iq35.mixed128",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    got = _cli(REPO)
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA" in got.stderr


def test_bare_directory_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "sdrbench", tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _cli(tmp_path)
    assert got.returncode != 0 and got.stdout == ""


def test_result_line_is_json(root, capsys):
    out = run(root, "tiny.ssb")
    line = json.dumps(out)
    assert json.loads(line)["device"]["memory_peak_bytes"] == 0
