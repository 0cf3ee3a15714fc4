"""The fused engine backend, port of ``repro.fleetsim.fused``.

The staged backend makes one host call per tick and launches each stage's
ops one by one (:func:`repro_torch.fleetsim.engine.advance`).  This backend
changes how the same tick is *executed*, never what it computes:

* **chunked run**: the ticks advance ``K`` at a time (default 512,
  clipped to ``n_ticks``), and the remainder ``n_ticks mod K`` runs as a
  tail;
* **dtype-packed carry**: at each chunk boundary the bounded integer state
  (queue ring ``head``/``count``, StateT) is packed to the narrowest dtype
  its static bound fits (:func:`pick_count_dtype`: uint8 / int16 / int32,
  widening, never wrapping) and unpacked for the next chunk.  The round
  trip is exact;
* **CUDA graph**: on a CUDA run the ticks of a chunk replay from one
  captured graph (:class:`TickBlocks`).  The graph holds ``L`` ticks, the
  largest divisor of ``K`` not above :data:`GRAPH_TICKS`, and replays
  ``K / L`` times a chunk; the tail replays it for its whole blocks of
  ``L`` and runs the rest on the staged loop.  The graph reads static
  buffers (the state, a device tick counter and the run's ``(G, n_ticks)``
  arrival counts, indexed by the device tick) and writes the new state
  back into them at its end.  A failed capture or replay raises; nothing
  falls back to the staged loop.  On the CPU the same block of ``L`` ticks
  runs eagerly, so the tests hold the captured code path to the reference.

Inside a block the tick is a 0-d device tensor: its time is a float32
device product (the same bits as the staged loop's host product) and the
recovery wipe is applied, masked, on every tick.  Each tick's draws come
from its own key chain, so grouping them by block changes no bits.  A
kernel wrapper's ``.launches`` counter counts its launches at capture, not
at replay: count replayed launches with the profiler.

Every tick replays :func:`repro_torch.fleetsim.stages.build_step` in the
staged order, so the fused backend is **bit-identical** to the staged one
for every ``K`` (``tests/test_torch_fused.py``), the coordinator and
hedge-timer stages included: their sub-states (``CoordState``,
``HedgeWheel``) ride the static buffers like the rest of the state and are
carried unpacked across chunk boundaries.  So is the batch server
(``server_model="batch"``), whose decode slots are the worker rows.
Configs with telemetry are staged-only, as in the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.fleetsim.config import FleetConfig
from repro_torch.fleetsim.engine import DRAW_CHUNK, advance, init_run
from repro_torch.fleetsim.stages import draw_ticks
from repro_torch.fleetsim.state import FleetState

#: default K: ticks a chunk advances between pack points
DEFAULT_TICKS_PER_CHUNK = 512
#: most ticks one CUDA graph holds: one group of draws (engine.DRAW_CHUNK)
GRAPH_TICKS = DRAW_CHUNK


# ------------------------------------------------------------ dtype packing --
def pick_count_dtype(bound: int) -> torch.dtype:
    """The narrowest integer dtype that exactly holds every count in
    ``[0, bound]``: uint8, int16, then int32; **raises** beyond int32,
    never wraps.  ``bound`` is static (a queue capacity), so a value that
    could overflow the packed dtype cannot exist by construction."""
    if bound < 0:
        raise ValueError(f"bound must be non-negative, got {bound}")
    for dt in (torch.uint8, torch.int16, torch.int32):
        if bound <= torch.iinfo(dt).max:
            return dt
    raise ValueError(
        f"bound {bound} exceeds int32; refusing to pack a counter that "
        "could silently wrap")


def pack_array(x: torch.Tensor, bound: int) -> torch.Tensor:
    """``x`` (non-negative, at most ``bound``) in its narrowest exact
    dtype (:func:`pick_count_dtype`)."""
    return x.to(pick_count_dtype(bound))


def pack_state(cfg: FleetConfig, state: FleetState) -> FleetState:
    """Dtype-pack the bounded integer state between chunks:
    ``queues.head`` ≤ Q−1, ``queues.count`` ≤ Q and StateT ≤ Q.  REQ_ID
    carriers, metrics and float payloads are untouched."""
    q = cfg.queue_cap
    # StateT holds the piggybacked queue length: the FCFS ring's depth, or
    # under the batch server the depth still waiting beyond the free
    # slots; both are ring counts after the dequeue, so at most Q.  Packing
    # runs between chunks, never in a captured graph
    assert int(state.switch.server_state.max()) <= q, "StateT above Q"
    return state._replace(
        switch=state.switch._replace(
            server_state=pack_array(state.switch.server_state, q)),
        queues=state.queues._replace(
            head=pack_array(state.queues.head, max(q - 1, 0)),
            count=pack_array(state.queues.count, q)))


def unpack_state(state: FleetState) -> FleetState:
    """Widen the packed state back to the int32 the stages compute in."""
    i32 = torch.int32
    return state._replace(
        switch=state.switch._replace(
            server_state=state.switch.server_state.to(i32)),
        queues=state.queues._replace(
            head=state.queues.head.to(i32),
            count=state.queues.count.to(i32)))


# ------------------------------------------------------------------ chunks --
def resolve_chunk(cfg: FleetConfig, ticks_per_chunk: int = 0) -> int:
    """The concrete K for this config (0 → default, clipped to n_ticks)."""
    k = ticks_per_chunk or DEFAULT_TICKS_PER_CHUNK
    return max(1, min(k, cfg.n_ticks))


def graph_ticks(k: int) -> int:
    """``L``: ticks one graph holds, the largest divisor of ``k`` not above
    :data:`GRAPH_TICKS`."""
    return max(d for d in range(1, min(k, GRAPH_TICKS) + 1) if k % d == 0)


def leaves(state: FleetState) -> list[torch.Tensor]:
    """The state's tensors in a fixed order (``None`` sub-states left
    out)."""
    out = []
    for x in state:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif x is not None:
            out.extend(leaves(x))
    return out


def write_back(static: FleetState, new: FleetState) -> None:
    """Copy every tensor of ``new`` into the same field of ``static``, but
    for the ones the ticks updated in place (same storage)."""
    for a, b in zip(leaves(static), leaves(new), strict=True):
        if a.data_ptr() != b.data_ptr():
            a.copy_(b)


def _clone(state: FleetState) -> FleetState:
    def tree(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return None if x is None else type(x)(*(tree(y) for y in x))
    return tree(state)


def run_block(cfg: FleetConfig, step, n_raw: torch.Tensor,
              state: FleetState, tick: torch.Tensor, n: int) -> None:
    """``n`` ticks from the device tick ``tick`` (a 0-d int64 tensor): the
    body a graph holds.  The new state is written back into ``state``'s
    tensors and ``tick`` advances by ``n``, both in place, so the block can
    run again on its own output."""
    ticks = tick + torch.arange(n, dtype=torch.int64, device=tick.device)
    counts = n_raw.index_select(1, ticks)            # (G, n)
    cur = state
    for first in range(0, n, DRAW_CHUNK):
        draws = draw_ticks(cfg, cur.key, min(DRAW_CHUNK, n - first))
        for i, d in enumerate(draws, first):
            cur = step(cur, (ticks[i], counts[:, i], d))
    write_back(state, cur)
    tick.add_(n)


@dataclass
class GraphStats:
    """What a fused run's graph cost and did (seconds by the host clock,
    each phase ending with a device synchronisation), and what a sharded
    run's placement cost."""

    ticks: int = 0              # L, ticks one graph holds
    replays: int = 0            # graph launches over the run
    warmup_s: float = 0.0       # one eager block on a copy of the state
    capture_s: float = 0.0      # stream capture of one block
    instantiate_s: float = 0.0  # cudaGraphInstantiate
    place_s: float = 0.0        # sharded: slabs placed on their devices

    @property
    def setup_s(self) -> float:
        return (self.warmup_s + self.capture_s + self.instantiate_s
                + self.place_s)


class TickBlocks:
    """Blocks of ``n`` ticks over static state buffers: replayed from a CUDA
    graph on a CUDA run, run eagerly on the CPU.

    ``state`` becomes the static buffers (its tensors are updated in
    place); :meth:`load` copies another state into them, :meth:`run`
    advances whole blocks from the run's first tick on, and :attr:`tick`
    holds the next tick on the device (:attr:`next_tick` on the host).  A
    block never runs past the run's last tick."""

    def __init__(self, cfg: FleetConfig, step, n_raw: torch.Tensor,
                 state: FleetState, n: int,
                 stats: GraphStats | None = None):
        self.cfg, self.step, self.n_raw, self.n = cfg, step, n_raw, n
        self.state = state
        dev = n_raw.device
        self.tick = torch.zeros((), dtype=torch.int64, device=dev)
        self.next_tick = 0
        self.stats = stats if stats is not None else GraphStats()
        self.stats.ticks = n
        self.graph = None
        if dev.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        """Warm up on a copy of the state, on a side stream (the kernels'
        first launches load their modules), then capture one block."""
        st = self.stats
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run_block(self.cfg, self.step, self.n_raw, _clone(self.state),
                      self.tick.clone(), self.n)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            run_block(self.cfg, self.step, self.n_raw, self.state, self.tick,
                      self.n)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        self.graph = graph
        st.warmup_s, st.capture_s, st.instantiate_s = t1 - t0, t2 - t1, \
            t3 - t2

    def load(self, state: FleetState) -> None:
        write_back(self.state, state)

    def run(self, n_blocks: int) -> None:
        stop = self.next_tick + n_blocks * self.n
        if stop > self.n_raw.shape[1]:
            raise ValueError(f"{n_blocks} blocks of {self.n} ticks from tick "
                             f"{self.next_tick} run past the run's "
                             f"{self.n_raw.shape[1]} ticks")
        self.next_tick = stop
        for _ in range(n_blocks):
            if self.graph is not None:
                self.graph.replay()
            else:
                run_block(self.cfg, self.step, self.n_raw, self.state,
                          self.tick, self.n)
        self.stats.replays += n_blocks if self.graph is not None else 0


def fused_core(cfg: FleetConfig, params, ticks_per_chunk: int = 0,
               stats: GraphStats | None = None) -> FleetState:
    """Advance a batched ``params`` (on its device) for ``cfg.n_ticks``
    ticks on the fused backend; returns the final state.

    Chunks of ``K`` ticks run between pack points (each chunk unpacks the
    packed state, advances ``K`` ticks and packs it again); the remainder
    ``n_ticks mod K`` runs as a tail.  ``stats`` receives the graph's
    costs on a CUDA run."""
    if cfg.telemetry:
        raise ValueError(
            "the fused backend does not run telemetry; telemetry configs "
            "run staged (EngineOptions(backend='auto') routes them there)")
    k = resolve_chunk(cfg, ticks_per_chunk)
    state, step, n_raw = init_run(cfg, params)
    blocks = TickBlocks(cfg, step, n_raw, state, graph_ticks(k),
                        stats=stats)
    n_chunks, n_tail = divmod(cfg.n_ticks, k)
    packed = pack_state(cfg, blocks.state)
    for _ in range(n_chunks):
        blocks.load(unpack_state(packed))
        blocks.run(k // blocks.n)
        packed = pack_state(cfg, blocks.state)
    blocks.load(unpack_state(packed))
    blocks.run(n_tail // blocks.n)
    done = cfg.n_ticks - n_tail % blocks.n
    return advance(cfg, blocks.state, step, n_raw, done, cfg.n_ticks)
