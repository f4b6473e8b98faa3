"""CLI entry: ``python -m phantomsdr_tpu_torch -c config.toml``.

Mirrors the reference main (reference: src/spectrumserver.cpp:299-372):
parse -c/--config TOML, reopen stdin binary, build the sample source
for the configured wire format, start the DSP driver and the serving
edge, install SIGINT shutdown.  Single process, on ``--device cuda``
(the default) or ``--device cpu``; with ``[tpu] mesh_devices = N`` the
server runs as a mesh of N shards: on N cards, or with ``--device cpu``
on N CPU shards.  With ``--num-processes N`` it is one process of an
N-process cluster (``parallel.multihost``): its shards are its visible
cards, or ``--cpu-devices`` CPU shards with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import faulthandler
import signal
import socket
import sys

from aiohttp import web

from .config import load_config
from .parallel.multihost import DEFAULT_LINK_PORT
from .runtime.driver import DSPDriver, SampleSource
from .runtime.server import SpectrumServer


def make_site(runner, host: str, port: int):
    """Listening site for the serving edge, reference listen semantics
    (src/spectrumserver.cpp:239-243: try IPv6 first, fall back to
    IPv4).  For the default all-interfaces bind this opens one IPv6
    dual-stack socket (IPV6_V6ONLY off), so v4 AND v6 clients reach a
    default deployment through the single listener; hosts without v6
    support fall back to the plain v4 bind.  An explicit ``[server]
    host`` is honored verbatim.  Returns (site, display_host)."""
    if host == "0.0.0.0":
        sock = None
        try:
            sock = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
            sock.bind(("::", port))
            return web.SockSite(runner, sock, backlog=8192), "[::]"
        except OSError:
            if sock is not None:
                sock.close()
    return (web.TCPSite(runner, host, port, backlog=8192,
                        reuse_address=True), host)


def build(cfg, stream, loop_file=False, throttle=0.0, device="cuda",
          mesh=None):
    """(server, driver) on ``device`` (in mesh mode: on ``mesh``, a
    device list, or mesh_devices devices of ``device``); the caller
    starts the driver and runs ``server.app``."""
    # build the native codec library up front, not on the serving path
    if cfg.audio_compression == "flac":
        from .runtime.codecs import _load_hostlib

        _load_hostlib()
    server = SpectrumServer(cfg)
    source = SampleSource(cfg, stream, loop_file=loop_file,
                          throttle_sps=throttle)
    driver = DSPDriver(
        cfg, source, server.channels,
        consumer=server.dispatch_threadsafe,
        waterfall_registry=server.waterfalls,
        waterfall_active=server.waterfall_active,
        audio_active=server.audio_active,
        device=device, mesh=mesh,
    )
    server.driver = driver
    return server, driver


def build_multihost(cfg, stream, link_addr, link_port, cluster,
                    loop_file=False, throttle=0.0):
    """Multi-host cluster build (``cluster``: ``multihost.bootstrap``'s):
    this process serves the channel slots living on its shards; process
    0 additionally ingests samples and distributes rows + control."""
    if cfg.audio_compression == "flac":
        from .runtime.codecs import _load_hostlib

        _load_hostlib()
    from .ops.quantize import pyramid_level_offsets
    from .parallel.multihost import MultihostDriver, MultihostRuntime
    from .runtime.registry import ChannelRegistry, WaterfallRegistry

    rt = MultihostRuntime(cfg, cluster)
    channels = ChannelRegistry(cfg, slot_offset=rt.chan_offset,
                               slot_count=rt.chan_count)
    waterfalls = WaterfallRegistry(
        cfg, pyramid_level_offsets(cfg.fft_result_size,
                                   cfg.downsample_levels),
        slot_offset=rt.chan_offset, slot_count=rt.chan_count)
    server = SpectrumServer(cfg, channels, waterfalls,
                            chan_offset=rt.chan_offset)
    source = None
    if rt.process_id == 0:
        source = SampleSource(cfg, stream, loop_file=loop_file,
                              throttle_sps=throttle, include_halo=False)
    driver = MultihostDriver(cfg, rt, source, server,
                             link_addr=link_addr, link_port=link_port)
    server.driver = driver
    return server, driver


def main(argv=None):
    # kill -USR1 <pid> dumps all thread stacks to stderr (debugging aid)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    ap = argparse.ArgumentParser(prog="phantomsdr-tpu-torch")
    ap.add_argument("-c", "--config", default="config.toml",
                    help="config file (=config.toml)")
    ap.add_argument("--input-file", default=None,
                    help="read samples from a file instead of stdin")
    ap.add_argument("--loop", action="store_true",
                    help="loop the input file forever")
    ap.add_argument("--throttle", action="store_true",
                    help="throttle file replay to the configured sps")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="compute device (=cuda); cpu runs the plain "
                         "PyTorch versions of the kernels.  With [tpu] "
                         "mesh_devices = N: N cards, or N CPU shards")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="cluster mode with --device cpu: N CPU shards "
                         "in this process (=1); a single process takes "
                         "its shard count from [tpu] mesh_devices")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 for a multi-host "
                         "cluster (torch.distributed's tcp:// rendezvous)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--link-port", type=int, default=DEFAULT_LINK_PORT,
                    help="ingest host's TCP port for the raw-row feed")
    ap.add_argument("--link-addr", default=None,
                    help="followers: ingest host's host:link-port "
                         "(default 127.0.0.1:<link-port>)")
    args = ap.parse_args(argv)
    if args.num_processes > 1 and not args.coordinator:
        ap.error("--num-processes > 1 needs --coordinator host:port")
    if args.cpu_devices and (args.num_processes <= 1
                             or args.device != "cpu"):
        ap.error("--cpu-devices applies to a cluster with --device cpu")

    cluster = None
    if args.num_processes > 1:
        # one process per host; before any other CUDA work
        from .parallel.multihost import bootstrap

        cluster = bootstrap(args.coordinator, args.num_processes,
                            args.process_id, device=args.device,
                            cpu_devices=args.cpu_devices)
    cfg = load_config(args.config)
    if args.input_file:
        stream = open(args.input_file, "rb")
    else:
        stream = sys.stdin.buffer

    throttle = cfg.sps if args.throttle else 0.0
    if cluster is not None:
        server, driver = build_multihost(cfg, stream, args.link_addr,
                                         args.link_port, cluster,
                                         loop_file=args.loop,
                                         throttle=throttle)
    else:
        server, driver = build(cfg, stream, loop_file=args.loop,
                               throttle=throttle, device=args.device)
    driver.start()

    async def _run():
        runner = web.AppRunner(server.app)
        await runner.setup()
        site, bind_host = make_site(runner, cfg.host, cfg.port)
        try:
            await site.start()
        except OSError:
            # bind failed: stop the driver threads before exiting or the
            # interpreter teardown races the device thread
            driver.stop()
            raise
        print(f"phantomsdr-tpu-torch serving on {bind_host}:{cfg.port} "
              f"(fft_size={cfg.fft_size}, sps={cfg.sps}, "
              f"{'real' if cfg.is_real else 'iq'}, {args.device})",
              flush=True)
        reg_task = None  # keep a strong ref: the loop holds tasks weakly
        if cfg.register_enable:
            from .runtime.register import registration_task

            reg_task = asyncio.create_task(registration_task(
                cfg, lambda: len(server.event_conns)))
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        if reg_task is not None:
            reg_task.cancel()
        driver.stop()
        await runner.cleanup()

    try:
        asyncio.run(_run())
    finally:
        if stream is not sys.stdin.buffer:
            stream.close()


if __name__ == "__main__":
    main()
