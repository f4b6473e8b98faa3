#!/usr/bin/env python3
"""Count the noise blanker's click samples over the same audio in either
package: tools/verify's ``nb`` capture through a ``DSPDriver`` with one
AM listener at client.py's wide window, once with the nr column off and
once on, from the start of the capture to its end (no loop).

    python tools/verify/captures.py --variant nb --out DIR --port 19450 --secs 60
    python tools/nb_clicks.py --dir DIR --package jax              # CPU
    python tools/nb_clicks.py --dir DIR --package torch [--device cpu]

Both runs keep the audio after ``--settle`` seconds (the AGC's 200 ms
window and the PLL's lock), the same samples in both, and count the
samples above 4x their rms as client.py does (its bar: on < 0.6 x off).
The JAX package runs on the CPU; the port runs on the card unless
``--device cpu``.  Prints one JSON line.

    python tools/nb_clicks.py --dir DIR --trace

instead steps both packages' ``HopPipeline`` on the CPU side by side over
the capture with nb on (the listener's table as the driver builds it)
and prints how their int16 audio agrees (samples that differ, up or
down, the least-squares gain between them) and, for each step where
they part by more than 1 LSB, the port's blanker at that step: its
largest residuals against its threshold, and whether JAX's blanker on
the port's input gives the port's output.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def run(pkg: str, cfg_path: Path, capture: bytes, truth: dict, nr: bool,
        device: str) -> np.ndarray:
    """The listener's int16 audio over the whole capture."""
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from phantomsdr_tpu.config import load_config
        from phantomsdr_tpu.runtime.driver import DSPDriver, SampleSource
        from phantomsdr_tpu.runtime.registry import ChannelRegistry
        kw = {}
    else:
        from phantomsdr_tpu_torch.config import load_config
        from phantomsdr_tpu_torch.runtime.driver import DSPDriver, SampleSource
        from phantomsdr_tpu_torch.runtime.registry import ChannelRegistry
        kw = {"device": device}
    cfg = load_config(str(cfg_path))
    channels = listener(ChannelRegistry, cfg, truth)
    slot = channels.slots[min(channels.slots)]
    channels.set_nr(slot, nr)
    wire = 1 if cfg.input_format == "u8" else 2
    blocks = len(capture) // (cfg.hop_batch * cfg.hop_size * 2 * wire)
    got: dict[int, np.ndarray] = {}
    done = threading.Event()

    def consumer(frame0, audio, *_):
        got[frame0] = np.asarray(audio)[:, slot.slot].reshape(-1).copy()
        if len(got) >= blocks:
            done.set()

    drv = DSPDriver(cfg, SampleSource(cfg, io.BytesIO(capture)), channels,
                    consumer, waterfall_active=lambda: False, **kw)
    drv.start()
    finished = done.wait(timeout=7200)
    drv.stop()
    if not finished or drv.metrics.device_errors:
        raise RuntimeError(f"{pkg}: {len(got)}/{blocks} batches, errors "
                           f"{drv.metrics.device_errors}")
    return np.concatenate([got[k] for k in sorted(got)]).astype(np.float64)


def listener(registry_cls, cfg, truth: dict):
    """A registry with client.py's nb listener (slot 0) opted in."""
    rsize = cfg.fft_result_size
    m = (0.5 + truth["f_off_hz"] / truth["sps"]) * rsize
    off_w = int(truth["wide_hz"] * rsize / truth["sps"])
    channels = registry_cls(cfg)
    slot = channels.acquire("nb")
    channels.retune(slot, int(m - off_w), m, int(m + off_w))
    channels.set_mode(slot, "AM")
    channels.set_nr(slot, True)
    return channels


def trace(d: Path, truth: dict, bucket: int = 32) -> dict:
    """Both packages' HopPipeline side by side on the CPU (see the module
    docstring)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import phantomsdr_tpu_torch.pipeline as tpipe
    from phantomsdr_tpu.config import load_config as jload
    from phantomsdr_tpu.ops import nb as jnb
    from phantomsdr_tpu.pipeline import HopPipeline as JPipeline
    from phantomsdr_tpu.pipeline import channels_from_numpy as jtable
    from phantomsdr_tpu_torch.config import load_config
    from phantomsdr_tpu_torch.ops import nb as tnb
    from phantomsdr_tpu_torch.runtime.driver import SampleSource
    from phantomsdr_tpu_torch.runtime.registry import ChannelRegistry

    jc, tc = jload(str(d / "config.toml")), load_config(str(d / "config.toml"))
    _, arrays, resets, _ = listener(ChannelRegistry, tc, truth).snapshot()
    # registry columns: l, r, m_idx, mode, active, nr, rds, am_env
    rows = tuple(a[:bucket] for a in arrays)
    jt = jtable(*rows[:5], nr=rows[5], rds=rows[6], am_env=rows[7])
    tt = tpipe.channels_from_numpy(*rows[:5], am_env=rows[7], rds=rows[6],
                                   nr=rows[5])
    jp, tp = JPipeline(jc), tpipe.HopPipeline(tc, device="cpu")
    js = jp.resize_channel_rows(jp.init_state(), bucket)
    ts = tp.resize_channel_rows(tp.init_state(), bucket)
    seen = {}
    blanker = tpipe.nb_process

    def spy(state, params, x):  # the port's blanker input of each step
        seen["in"] = (state, params, x)
        return blanker(state, params, x)

    tpipe.nb_process = spy
    src = SampleSource(tc, io.BytesIO((d / "capture.s16").read_bytes()))
    ja, ta, parted = [], [], []
    reset = resets[:bucket]
    for step in range(1 << 30):
        raw = src.read_block()
        if raw is None:
            break
        js, jo = jp.step(js, jnp.asarray(raw), jt, waterfall="off",
                         reset=jnp.asarray(reset) if step == 0 else None)
        ts, to = tp.step(ts, torch.from_numpy(raw), tt, waterfall="off",
                         reset=torch.from_numpy(reset) if step == 0 else None)
        ja.append(np.asarray(jo.audio)[:, 0].reshape(-1).astype(np.int64))
        ta.append(to.audio.numpy()[:, 0].reshape(-1).astype(np.int64))
        if np.abs(ja[-1] - ta[-1]).max() <= 1:
            continue
        state, params, x = seen["in"]
        _, out, _, _, thr, temp = tnb.nb_process_detail(
            tnb.NBState(tail=state.tail[:1]), params, x[:1])
        _, jout = jnb.nb_process(
            jnb.NBState(tail=jnp.asarray(state.tail[:1].numpy())),
            jnb.NBParams(*params), jnp.asarray(x[:1].numpy()))
        parted.append({
            "step": step, "max_abs_diff": int(np.abs(ja[-1] - ta[-1]).max()),
            "threshold": float(thr[0]),
            "largest_residuals": temp[0].abs().topk(3).values.tolist(),
            "jax_blanker_on_port_input_max_diff": float(
                np.abs(np.asarray(jout) - out.numpy()).max())})
    ja, ta = np.concatenate(ja), np.concatenate(ta)
    diff = ta - ja
    near = np.abs(diff) <= 1
    return {"samples": int(ja.size), "differ": int((diff != 0).sum()),
            "up": int((diff > 0).sum()), "down": int((diff < 0).sum()),
            "gain": float((ta[near] * ja[near]).sum()
                          / (ja[near] * ja[near]).sum()),
            "parted_steps": parted}


def clicks(x: np.ndarray) -> int:
    """client.py's count: samples above 4x the rms."""
    return int(np.sum(np.abs(x) > 4.0 * np.sqrt(np.mean(x ** 2))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--settle", type=float, default=1.0)
    args = ap.parse_args()
    d = Path(args.dir)
    truth = json.loads((d / "truth.json").read_text())
    if args.trace:
        print(json.dumps({"trace": trace(d, truth)}), flush=True)
        return 0
    if args.package is None:
        ap.error("--package or --trace")
    capture = (d / "capture.s16").read_bytes()
    res = {"package": args.package,
           "device": "cpu" if args.package == "jax" else args.device}
    audio = {}
    for name, nr in (("off", False), ("on", True)):
        t = time.perf_counter()
        audio[name] = run(args.package, d / "config.toml", capture, truth, nr,
                          args.device)
        res[f"wall_s_{name}"] = time.perf_counter() - t
    fs = truth["audio_sps"]
    skip = int(args.settle * fs)
    n = min(len(audio["off"]), len(audio["on"]))
    counts = {k: clicks(v[skip:n]) for k, v in audio.items()}
    res.update(audio_seconds=(n - skip) / fs, clicks=counts,
               ratio=counts["on"] / max(counts["off"], 1),
               passes_client_bar=counts["on"] < 0.6 * counts["off"])
    if res["device"] == "cuda":
        import torch

        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
