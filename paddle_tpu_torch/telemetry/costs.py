"""Device-cost ledger + compile watch: price every dispatch from an
analytic model of the serving programs.

Port of ``paddle_tpu/telemetry/costs.py``. The reference prices each
jitted serving program once per (op, shape signature) with the
compiler's own numbers (``fn.lower(*args).compile().cost_analysis()``).
The port has no compiler to ask: its programs are eager PyTorch calls
into hand-written CUDA kernels. So ``program(op, fn, args, price)``
takes the price from the caller, an analytic FLOP and byte count of the
launch (``paddle_tpu_torch.models.costs``, built from the model's
config: the projections and MLP over the rows the launch runs, each
weight read once, attention over the K and V rows the kernel's route
reads). The numbers are a model, not a compiler's ground truth; where
the model does not know a function (``price=None``) the call falls back
to a zero-cost entry and bumps ``price_errors``, as the reference does
for a function it cannot lower.

- **Cost catalog**: every dispatch charges its price's FLOPs and bytes
  into ``server_flops_total{op}`` / ``server_hbm_bytes_total{op}``.
  Attention's bytes follow the slot lengths the host knows, so the
  price is per dispatch (``_PricedProgram.at``), while the catalog
  entry, and with it the compile watch, is per (op, signature).
  Host<->device data movement that is not a program (slot-state pushes,
  page gathers/scatters, block-table syncs) is priced as BYTES MOVED
  via ``charge_bytes`` — flops 0, documented per site.
- **Compile watch**: the first dispatch of each new (op, signature) is
  a compile: timed (``server_compiles_total{op}``,
  ``serving_compile_seconds``). In the port a new signature is a new
  static tick shape (a chunk width on the prefill ladder, a schedule
  length), the thing CUDA graphs of the tick would be keyed by.
  ``compile_s`` is the time spent pricing plus, when that first call
  built kernel libraries (``ops.kernels._build``, nvcc at first use),
  the build's seconds. Once an OP has WARMED (``warm_after_ticks``
  consecutive charged ticks without a compile of THAT op; warm-up is
  per op) any further compile of it is flagged a RECOMPILE — the server
  lands it as a flight-recorder event and a ``compile_stall`` journey
  phase on every request parked behind the stalled tick. ``warmed``
  (the global view) is true once every compiled op has warmed. A
  pricing failure is not a compile and never feeds the watch.
- **Tick-phase attribution**: the server splits each tick's wall into
  phases (admission / prefill_launch / decode_launch / fused_launch
  / token_callbacks / bookkeeping) through ``phase_timer()``; phases
  publish as ``serving_tick_phase_seconds{phase}`` and ride the
  recorder's per-tick events. Launches on the card are asynchronous:
  a phase's wall holds device time only where the host waits, and the
  server's waits are the ``.cpu()`` reads that close the prefill, decode
  and fused launches (the server says which phase takes each wait).
  ``token_callbacks`` is measured outside the server lock after the
  tick flushes, so it folds into the NEXT CHARGED tick's breakdown — a
  one-tick skew, carried across idle polls.
- **MFU / roofline**: per charged tick, achieved FLOPs/s over
  ``peak_flops`` is published as the ``serving_mfu`` gauge (and
  ``roofline_ratio`` — the max of the FLOPs and bytes utilizations —
  rides ``snapshot()``). Peaks are injectable; the defaults are
  CPU-safe placeholders (1 TFLOP/s, 100 GB/s) so the gauge is
  well-defined on any backend — inject the card's data-sheet rates.
  Since the model counts no activation traffic, the ratios understate
  the device's use; a ratio above 1 would mean the model counts work
  the device did not do.

Cost contract (mirrors ``FlightRecorder``/``GoodputLedger``):
``charge``/``charge_bytes``/``add_phase`` are plain dict bumps under
the server's own lock — no clock reads, no extra lock; ``program()``
reads the clock only on a new signature; ``flush_tick`` takes one short
catalog lock to fold the tick into cumulative totals (cross-thread
``/stats`` reads). A DISABLED catalog (``enabled=False``) is treated by
the server exactly like ``None`` — one attribute check on the tick
path, zero locks, zero clock reads.

Known cut (the reference's): the DENSE-mode admission prefill
(``model._run_prefill``) is counted in the dispatch profile but not
priced; the ragged path, the paged default, is.

Published surfaces: the metrics above, ``snapshot()`` under
``/stats["costs"]``, a ``costs`` postmortem section (with the last
tick's phase breakdown), and ``mfu()`` in the server's
``utilization()`` digest.
"""
import threading

from .clock import MonotonicClock

__all__ = ["CostCatalog", "COMPILE_BUCKETS", "PHASE_BUCKETS",
           "TICK_PHASES"]

# compiles span ~10 ms (pricing alone) to minutes (a kernel build)
COMPILE_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0)
# per-tick phase slices live at the serving-tick scale
PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
TICK_PHASES = ("admission", "prefill_launch", "decode_launch",
               "fused_launch", "token_callbacks", "bookkeeping")

# CPU-safe placeholder peaks: any positive number keeps the MFU gauge
# well-defined without hardware introspection; inject the card's own
# data-sheet rates in production
DEFAULT_PEAK_FLOPS = 1e12
DEFAULT_PEAK_HBM = 1e11


def _signature(args):
    """Hashable shape/dtype signature of a call's arguments: tensors and
    arrays by (shape, dtype), dicts by sorted key, lists and tuples in
    order, anything else by (type name, repr)."""
    sig = []

    def walk(a):
        if isinstance(a, dict):
            for k in sorted(a):
                walk(a[k])
        elif isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        else:
            shp = getattr(a, "shape", None)
            if shp is not None:
                sig.append((tuple(int(d) for d in shp),
                            str(getattr(a, "dtype", ""))))
            else:
                sig.append((type(a).__name__, repr(a)))

    walk(args)
    return tuple(sig)


def _build_seconds():
    """Cumulative seconds ``ops.kernels._build`` spent compiling kernel
    libraries in this process (0.0 when nothing was built)."""
    from ..ops.kernels import _build
    return _build.build_seconds()


class _PricedProgram:
    """One cataloged (op, signature): the callable plus this dispatch's
    price. Calling it dispatches the program AND charges the price to
    the current tick — dispatch and charge cannot drift.
    ``compiled_now``/``recompile`` tell the caller whether THIS lookup
    was a new signature (and whether it came after warm-up); the compile
    is recorded at its first call, which may build kernels."""

    __slots__ = ("op", "sig", "flops", "hbm_bytes", "compile_s",
                 "compiled_now", "recompile", "_fn", "_catalog",
                 "_first")

    def __init__(self, catalog, op, sig, fn, flops, hbm_bytes,
                 compile_s):
        self._catalog = catalog
        self._fn = fn
        self.op = op
        self.sig = sig
        self.flops = flops
        self.hbm_bytes = hbm_bytes
        self.compile_s = compile_s
        self.compiled_now = False
        self.recompile = False
        self._first = False

    def at(self, price):
        """Set this dispatch's ``(flops, hbm_bytes)``; returns self."""
        self.flops, self.hbm_bytes = (float(x) for x in price)
        return self

    def __call__(self, *args):
        if not self._first:
            out = self._fn(*args)
        else:
            self._first = False
            b0 = _build_seconds()
            out = self._fn(*args)
            self.compile_s += _build_seconds() - b0
            self._catalog._record_compile(self)
        self._catalog.charge(self)
        return out


class CostCatalog:
    """Priced-program catalog + compile watch + tick phases.

    >>> cat = CostCatalog(registry=tele.registry,
    ...                   peak_flops=989e12, peak_hbm_bytes_per_s=3.35e12)
    >>> srv = ContinuousBatchingServer(model, ..., costs=cat)
    >>> srv.run()
    >>> cat.snapshot()["ops"]["decode"]["flops"]
    >>> cat.recompiles                       # 0 after warmup, or else

    A first call's kernel build (the build module's cumulative build
    seconds before and after it) joins its compile time."""

    def __init__(self, registry=None, clock=None, enabled=True,
                 peak_flops=None, peak_hbm_bytes_per_s=None,
                 warm_after_ticks=2):
        self.enabled = bool(enabled)
        self.clock = clock if clock is not None else MonotonicClock()
        self.peak_flops = float(peak_flops if peak_flops is not None
                                else DEFAULT_PEAK_FLOPS)
        self.peak_hbm_bytes_per_s = float(
            peak_hbm_bytes_per_s if peak_hbm_bytes_per_s is not None
            else DEFAULT_PEAK_HBM)
        if self.peak_flops <= 0 or self.peak_hbm_bytes_per_s <= 0:
            raise ValueError("peak_flops / peak_hbm_bytes_per_s must "
                             "be > 0")
        self._warm_after = int(warm_after_ticks)
        self._lock = threading.Lock()
        self._programs = {}       # (op, sig) -> _PricedProgram
        self._tick = {}           # op -> [flops, bytes, dispatches]
        self._phases = {}         # phase -> seconds (current tick)
        self._totals = {}         # op -> [flops, bytes, dispatches]
        self._compiles = {}       # op -> count
        self._compile_s_total = 0.0
        self._ticks = 0
        # PER-OP compile watch: each op warms after warm_after_ticks
        # consecutive charged ticks without a compile of THAT op,
        # independently of the others' ladders
        self._quiet = {}          # op -> charged ticks since its compile
        self._warm = set()        # ops whose recompile alarm is armed
        self._compiled_ops = set()   # ops compiled since the last flush
        self.recompiles = 0
        self.price_errors = 0
        self._last_phases = {}
        self._last_mfu = None
        self._last_roofline = None
        self._c_flops = self._c_bytes = self._c_compiles = None
        self._h_compile = self._h_phase = self._g_mfu = None
        self._flops_children = {}
        self._bytes_children = {}
        self._compile_children = {}
        self._phase_children = {}
        if (self.enabled and registry is not None
                and getattr(registry, "enabled", False)):
            self._c_flops = registry.counter(
                "server_flops_total",
                "Device FLOPs charged per dispatch from the analytic "
                "cost model, by op", labelnames=("op",))
            self._c_bytes = registry.counter(
                "server_hbm_bytes_total",
                "Device memory bytes charged per dispatch (analytic "
                "model for programs, bytes-moved model for transfers), "
                "by op", labelnames=("op",))
            self._c_compiles = registry.counter(
                "server_compiles_total",
                "New (op, shape signature) events per op — growth "
                "after warmup means a new static tick shape mid-"
                "serving", labelnames=("op",))
            self._h_compile = registry.histogram(
                "serving_compile_seconds",
                "Wall seconds per new signature of one serving program "
                "(pricing, plus a kernel build its first call "
                "triggered)", buckets=COMPILE_BUCKETS)
            self._h_phase = registry.histogram(
                "serving_tick_phase_seconds",
                "One tick's wall split by phase (admission / "
                "prefill_launch / decode_launch / token_callbacks / "
                "bookkeeping) — the host-bound-vs-device-bound "
                "verdict", labelnames=("phase",),
                buckets=PHASE_BUCKETS)
            self._g_mfu = registry.gauge(
                "serving_mfu",
                "Achieved FLOP/s over peak_flops for the last charged "
                "tick (merged by MEAN on /fleet, like *_ratio gauges)")

    # --------------------------------------------------------- pricing
    def program(self, op, fn, args, price=None):
        """The priced callable for ``fn`` at ``args``' shape signature,
        charging ``price`` (``(flops, hbm_bytes)`` of this dispatch, or
        a zero-argument callable returning it). First sight of (op,
        signature) is timed (pricing; the kernel build, if its first
        call triggers one) and recorded as a compile at that first
        call; repeats are a dict hit. ``price=None`` — a function the
        model does not know — keeps a zero-cost entry and bumps
        ``price_errors`` once, never the compile watch."""
        if not self.enabled:
            return fn
        key = (op, _signature(args))
        prog = self._programs.get(key)
        if prog is not None:
            prog.compiled_now = False
            if price is not None:
                prog.at(price() if callable(price) else price)
            return prog
        t0 = self.clock.now()
        flops = hbm = 0.0
        priced = price is not None
        if priced:
            flops, hbm = price() if callable(price) else price
        else:
            self.price_errors += 1
        dt = self.clock.now() - t0
        prog = _PricedProgram(self, op, key[1], fn, float(flops),
                              float(hbm), dt)
        prog.compiled_now = priced
        prog._first = priced
        # per-op alarm: only a new signature of an op whose OWN watch
        # armed (warm_after_ticks charged ticks without one) is a
        # recompile — another op's ladder climb neither arms nor trips
        # this one
        prog.recompile = priced and op in self._warm
        self._programs[key] = prog
        return prog

    def _record_compile(self, prog):
        op, dt = prog.op, prog.compile_s
        with self._lock:
            self._compiled_ops.add(op)
            self._compiles[op] = self._compiles.get(op, 0) + 1
            self._compile_s_total += dt
            if prog.recompile:
                self.recompiles += 1
        if self._c_compiles is not None:
            child = self._compile_children.get(op)
            if child is None:
                child = self._compile_children[op] = \
                    self._c_compiles.labels(op=op)
            child.inc()
            self._h_compile.observe(dt)

    # -------------------------------------------------------- charging
    def charge(self, prog, n=1):
        """Charge ``n`` dispatches of a cataloged program to the
        current tick. Dict bump only — callers already hold the server
        lock (single writer per catalog), no clock reads."""
        cell = self._tick.get(prog.op)
        if cell is None:
            cell = self._tick[prog.op] = [0.0, 0.0, 0]
        cell[0] += prog.flops * n
        cell[1] += prog.hbm_bytes * n
        cell[2] += n

    def charge_bytes(self, op, nbytes, n=1):
        """Charge a host<->device transfer that is not a program
        (slot-state push, page gather/scatter, block-table sync): bytes
        moved, zero FLOPs. The byte count is the caller's model of the
        movement (documented per site)."""
        cell = self._tick.get(op)
        if cell is None:
            cell = self._tick[op] = [0.0, 0.0, 0]
        cell[1] += float(nbytes) * n
        cell[2] += n

    # ---------------------------------------------------------- phases
    def phase_timer(self):
        """A per-tick phase splitter on the catalog's clock:
        ``mark(phase)`` attributes the wall since the previous mark TO
        ``phase`` (accumulating), ``close(phase)`` sweeps any trailing
        remainder. One instance per tick, server-lock single-writer."""
        return _PhaseTimer(self)

    def add_phase(self, phase, seconds):
        if seconds > 0:
            self._phases[phase] = self._phases.get(phase, 0.0) + seconds

    def pending_phases(self):
        """The current (unflushed) tick's phase split — what the
        recorder embeds in its per-tick event."""
        return dict(self._phases)

    # ----------------------------------------------------------- flush
    def flush_tick(self):
        """Fold the tick's charges + phases into cumulative totals,
        publish metrics, and advance the compile watch's PER-OP
        warmup: a charged tick is quiet FOR AN OP when that op did not
        compile in it; ``warm_after_ticks`` consecutive quiet ticks
        arm that op's recompile detection (warmth is sticky). Returns
        the tick's ``{op: [flops, bytes, dispatches]}``, or None when
        nothing was charged — an idle serve-loop poll, whose phase
        scraps are DISCARDED (pending ``token_callbacks`` time is
        carried to the next charged tick)."""
        tick, self._tick = self._tick, {}
        phases, self._phases = self._phases, {}
        if not tick:
            cb = phases.get("token_callbacks")
            if cb:
                self._phases["token_callbacks"] = cb
            return None
        elapsed = sum(phases.values())
        tick_flops = sum(c[0] for c in tick.values())
        tick_bytes = sum(c[1] for c in tick.values())
        mfu = roofline = None
        if elapsed > 0:
            mfu = (tick_flops / elapsed) / self.peak_flops
            roofline = max(mfu, (tick_bytes / elapsed)
                           / self.peak_hbm_bytes_per_s)
        with self._lock:
            for op, cell in tick.items():
                tot = self._totals.get(op)
                if tot is None:
                    tot = self._totals[op] = [0.0, 0.0, 0]
                tot[0] += cell[0]
                tot[1] += cell[1]
                tot[2] += cell[2]
            if phases:
                self._last_phases = phases
            self._ticks += 1
            for op in self._compiles:
                if op in self._compiled_ops:
                    self._quiet[op] = 0
                else:
                    self._quiet[op] = self._quiet.get(op, 0) + 1
                    if self._quiet[op] >= self._warm_after:
                        self._warm.add(op)
            self._compiled_ops.clear()
            if mfu is not None:
                self._last_mfu = mfu
                self._last_roofline = roofline
        if self._c_flops is not None:
            for op, cell in tick.items():
                if cell[0]:
                    child = self._flops_children.get(op)
                    if child is None:
                        child = self._flops_children[op] = \
                            self._c_flops.labels(op=op)
                    child.inc(cell[0])
                if cell[1]:
                    child = self._bytes_children.get(op)
                    if child is None:
                        child = self._bytes_children[op] = \
                            self._c_bytes.labels(op=op)
                    child.inc(cell[1])
            for phase, s in phases.items():
                child = self._phase_children.get(phase)
                if child is None:
                    child = self._phase_children[phase] = \
                        self._h_phase.labels(phase=phase)
                child.observe(s)
            if mfu is not None:
                self._g_mfu.set(mfu)
        return tick or None

    # ------------------------------------------------------------ read
    @property
    def warmed(self):
        """Global warm view: every op that has ever compiled has
        finished its own ``warm_after_ticks`` quiet run."""
        with self._lock:
            return bool(self._compiles) \
                and all(op in self._warm for op in self._compiles)

    def warmed_op(self, op):
        """Whether ``op``'s own recompile alarm is armed."""
        return op in self._warm

    def mfu(self):
        """The last charged tick's model-FLOPs utilization (achieved
        FLOP/s over ``peak_flops``), or None before any charged tick."""
        return self._last_mfu

    def totals(self):
        """Cumulative ``{op: {"flops", "hbm_bytes", "dispatches"}}``."""
        with self._lock:
            return {op: {"flops": c[0], "hbm_bytes": c[1],
                         "dispatches": c[2]}
                    for op, c in self._totals.items()}

    @property
    def ticks(self):
        return self._ticks

    def compiles(self):
        """Cumulative compile counts by op."""
        with self._lock:
            return dict(self._compiles)

    def snapshot(self):
        """JSON-ready summary — the ``/stats["costs"]`` payload and the
        ``costs`` postmortem section (per-op totals, compile counts,
        warmup/recompile state, MFU/roofline, and the LAST tick's
        phase breakdown)."""
        with self._lock:
            return {
                "ops": {op: {"flops": c[0], "hbm_bytes": c[1],
                             "dispatches": c[2]}
                        for op, c in self._totals.items()},
                "compiles": dict(self._compiles),
                "compile_seconds": self._compile_s_total,
                "cataloged_programs": len(self._programs),
                "recompiles": self.recompiles,
                "warmed": bool(self._compiles) and all(
                    op in self._warm for op in self._compiles),
                "warm_ops": sorted(self._warm),
                "price_errors": self.price_errors,
                "ticks": self._ticks,
                "mfu": self._last_mfu,
                "roofline_ratio": self._last_roofline,
                "peak_flops": self.peak_flops,
                "peak_hbm_bytes_per_s": self.peak_hbm_bytes_per_s,
                "last_tick_phases": dict(self._last_phases),
            }


class _PhaseTimer:
    """Splits one tick's wall into named phases. ``mark(phase)``
    charges the time since the last mark (or construction) to
    ``phase``; phases may repeat (accumulate). ``close(phase)`` sweeps
    whatever trails the final mark so the phases sum to the tick wall
    even on early-return ticks."""

    __slots__ = ("_catalog", "_clock", "_t")

    def __init__(self, catalog):
        self._catalog = catalog
        self._clock = catalog.clock
        self._t = self._clock.now()

    def mark(self, phase):
        t = self._clock.now()
        self._catalog.add_phase(phase, t - self._t)
        self._t = t

    close = mark
