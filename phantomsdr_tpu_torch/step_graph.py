"""The single-device hop step replayed as a captured CUDA graph.

Issued op by op, one ``HopPipeline.step`` is about 150 small device
operations (the format convert, cuFFT, the demod math, the hand-written
kernels) launched from one Python thread, and the card finishes each
before the host has launched the next.  ``StepGraphs`` captures each
variant of the step once into a ``torch.cuda.CUDAGraph`` and replays it:
the same kernels in the same order on the same shapes, issued by one
graph launch.

A variant, the graph's key, is what the eager step branches on in
Python and what sets its shapes: the channel-table width (the bucket),
the view-table width, the waterfall mode, the table's ``need_pll``,
``need_rds`` and ``need_nr``, the hop counter's parity, and the raw
block's shape, dtype and device.  A step whose key has no graph runs
eagerly, which leaves cuFFT plans, kernel builds and weight caches in
place, and then captures the key; a key whose capture raises stays
eager, its error kept in ``failed``.

A graph reads and writes fixed addresses, its static buffers: the raw
block (copied in before every replay), the channel table, the view table
and the due rows (copied in when another object is passed than the last
one), and the carries of its table width (copied in when the state
passed is not the one a replay returned).  Every graph of one table
width reads and writes the same carries, so steps that alternate the
waterfall modes copy none.  A graph writes its new carries back into
them and its outputs into its own buffers, in one memory pool that
every graph shares, since no two graphs replay at once.

A replay calls no kernel wrapper, so it credits each kernel's
``launches`` with the launches its capture recorded; the capture, which
ran nothing on the device, takes back what its wrappers counted.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def flat_tensors(x) -> list[torch.Tensor]:
    """The tensors of a tensor or a (nested) NamedTuple, in field order;
    other fields (the table's booleans) are left out."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in flat_tensors(v)]
    return []


def rebuild(template, flat: list[torch.Tensor]):
    """``template`` with its tensors replaced, in order, by ``flat``."""
    it = iter(flat)

    def put(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, tuple):
            return type(x)(*(put(v) for v in x))
        return x
    return put(template)


def fits(dst: list[torch.Tensor], src: list[torch.Tensor]) -> bool:
    return len(dst) == len(src) and all(
        d.shape == s.shape and d.dtype == s.dtype for d, s in zip(dst, src))


def copy_into(dst: list[torch.Tensor], src: list[torch.Tensor]) -> None:
    """dst[i] <- src[i] on the current stream, skipping a source that is
    its destination; a source that shares memory with any destination is
    cloned first, so that no copy reads what another has written."""
    held = {d.untyped_storage().data_ptr() for d in dst if d.numel()}
    pairs = []
    for d, s in zip(dst, src):
        if not d.numel() or s is d or (
                s.data_ptr() == d.data_ptr() and s.stride() == d.stride()):
            continue
        if s.untyped_storage().data_ptr() in held:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


class Static:
    """Tensors a graph reads at fixed addresses: ``value`` is the source
    object rebuilt around them; ``src`` the object whose tensors they
    hold (nothing is copied while the same object comes back)."""

    def __init__(self, src):
        self.tensors = [t.clone() for t in flat_tensors(src)]
        self.value = rebuild(src, self.tensors)
        self.src = src

    def fill(self, src, always: bool = False) -> bool:
        """Copy ``src``'s tensors in (``always``: even where ``src`` came
        last); False where they do not fit."""
        if src is self.value or (src is self.src and not always):
            return True
        flat = flat_tensors(src)
        if not fits(self.tensors, flat):
            return False
        copy_into(self.tensors, flat)
        self.src = src
        return True


class Graph(NamedTuple):
    replay: Callable[[], None]
    out: object          # the HopOutputs every replay writes
    credits: tuple       # (kernel, launches) a replay issues


def cuda_capture(device: torch.device) -> Callable:
    """``capture(body) -> (what body returned, replay)``: body's device
    work recorded, not run, into a ``torch.cuda.CUDAGraph`` on a side
    stream, in one memory pool for every graph this function captures.
    Every graph, one whose capture failed too, stays referenced here: the
    caching allocator frees a shared pool when its last graph goes, and
    then refuses the next capture into it."""
    with torch.cuda.device(device):
        pool = torch.cuda.graph_pool_handle()
    side = torch.cuda.Stream(device)
    graphs = []

    def capture(body):
        graph = torch.cuda.CUDAGraph()
        graphs.append(graph)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                out = body()
            finally:
                graph.capture_end()
        current.wait_stream(side)
        return out, graph.replay
    return capture


class StepGraphs:
    """The captured variants of one pipeline's step.

    ``eager(state, raw, chans, views, waterfall, reset, due_idx)`` is the
    step issued op by op; ``kernels`` the launch counters a replay
    credits; ``capture`` records a body (``cuda_capture``)."""

    def __init__(self, eager: Callable, hop_batch: int, kernels: list,
                 capture: Callable):
        self.eager = eager
        self.hop_batch = hop_batch
        self.kernels = kernels
        self.capture = capture
        self.captures = 0          # graphs captured so far
        self.replayed = False      # whether the last step was a replay
        self.failed: dict = {}     # key -> the error its capture raised
        self.graphs: dict = {}     # key -> Graph
        self._carries: dict[int, Static] = {}   # by table width
        self._tables: dict[int, Static] = {}    # by table width
        self._views: dict[int, Static] = {}     # by view-table width
        self._raw: dict[tuple, Static] = {}     # by (shape, dtype, device)
        self._due: Static | None = None

    @staticmethod
    def key(state, raw, chans, views, waterfall: str) -> tuple:
        return (chans.l.shape[0], views.start.shape[0], waterfall,
                chans.need_pll, chans.need_rds, chans.need_nr,
                state.frame & 1, tuple(raw.shape), raw.dtype, raw.device)

    def step(self, state, raw, chans, views, waterfall: str, due_idx):
        """The step of ``HopPipeline.step`` (no reset mask, ``views``
        resolved), replayed where its key has a graph."""
        key = self.key(state, raw, chans, views, waterfall)
        graph = self.graphs.get(key)
        self.replayed = False
        if graph is None:
            out = self.eager(state, raw, chans, views, waterfall, None,
                             due_idx)
            if key not in self.failed:
                self._capture(key, state, raw, chans, views, waterfall,
                              due_idx)
            return out
        k = key[0]
        carries = self._carries[k]
        if not (carries.fill(state.audio)
                and (waterfall != "views" or self._due.fill(due_idx))):
            return self.eager(state, raw, chans, views, waterfall, None,
                              due_idx)
        self._raw[key[7:]].fill(raw, always=True)    # by shape, dtype, device
        self._tables[k].fill(chans)
        self._views[key[1]].fill(views)
        graph.replay()
        carries.src = carries.value      # what the graph wrote
        for kernel, n in graph.credits:
            kernel.launches += n
        self.replayed = True
        return (state._replace(frame=state.frame + self.hop_batch,
                               audio=carries.value), graph.out)

    def _static(self, store: dict, at, src) -> Static:
        got = store.get(at)
        if got is None:
            got = store[at] = Static(src)
        return got

    def _capture(self, key, state, raw, chans, views, waterfall: str,
                 due_idx) -> None:
        k = key[0]
        carries = self._static(self._carries, k, state.audio)
        carries.src = None     # the next replay copies its state in
        table = self._static(self._tables, k, chans).value._replace(
            need_pll=chans.need_pll, need_rds=chans.need_rds,
            need_nr=chans.need_nr)
        views_s = self._static(self._views, key[1], views).value
        raw_s = self._static(self._raw, key[7:], raw).value
        due_s = None
        if waterfall == "views":
            if self._due is None:
                self._due = Static(due_idx)
            due_s = self._due.value
        state_s = state._replace(audio=carries.value)
        eager = self.eager

        def body():
            new, out = eager(state_s, raw_s, table, views_s, waterfall, None,
                             due_s)
            copy_into(carries.tensors, flat_tensors(new.audio))
            return out

        before = [kernel.launches for kernel in self.kernels]
        try:
            out, replay = self.capture(body)
        except RuntimeError as e:
            self.failed[key] = repr(e)[:300]
            return
        finally:
            counted = [kernel.launches - n
                       for kernel, n in zip(self.kernels, before)]
            for kernel, n in zip(self.kernels, before):
                kernel.launches = n
        self.graphs[key] = Graph(replay, out, tuple(
            (kernel, n) for kernel, n in zip(self.kernels, counted) if n))
        self.captures += 1
