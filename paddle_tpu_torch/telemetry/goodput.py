"""Goodput ledger: attribute every device token to useful work or a
named waste reason.

Copied from ``paddle_tpu/telemetry/goodput.py``: the class is the
reference's unchanged; what it counts is set by the server's hooks, and
the port's device work differs from the reference's in three places
(listed after the taxonomy). Journeys answer "what happened to request
X"; this answers "how much of the hardware's work is USEFUL?". The
decode program steps every slot every tick whether or not the slot
holds live work, the ragged
prefill pads chunk widths up a pow2 ladder, the paged kernels DMA pages
they then mask out, and a preemption replays its whole chain from token
0 — waste that was previously scattered across two ad-hoc counters
(``kv_null_redirected_writes_total``,
``serving_wasted_block_tokens_total``) or not measured at all. The
performance work (fused ticks, live-row prefill, speculative decode)
claims wins in exactly these categories, so this ledger is the baseline
it is judged against.

Taxonomy — every device token each tick lands in EXACTLY ONE kind:

- ``goodput``          committed prefill rows (fresh prompt tokens
                       written once) and committed decode rows
- ``null_redirect``    decode rows of slots holding no live decode work
                       (empty slots, and mid-prefill slots parked past
                       the block table so their writes null-redirect —
                       the dense backend drops them out of bounds, same
                       waste class)
- ``chunk_pad``        prefill rows padded past the real chunk: the
                       ragged pow2 ladder and the dense
                       ``prefill_chunk`` remainder pad
- ``skipped_page_dma`` page tokens the paged decode / ragged-prefill
                       kernels DMA but mask: the kernel grid covers the
                       full block-table width per slot, so pages wholly
                       beyond a slot's live length still cost a DMA
                       (a known cut; counted for LIVE slots only —
                       an idle slot's whole ride is already
                       ``null_redirect``)
- ``replay``           preemption recompute (a known cut): prompt
                       re-prefill rows of a resumed request, and decode
                       rows re-generating tokens its waiter was already
                       streamed
- ``tail_reprefill``   sub-page tails of registered prefixes the ragged
                       path re-prefills (page-granular tree matching,
                       a stats-contract change)
- ``block_waste``      decode rows a ``tick_block > 1`` program runs
                       past a slot's finish (amortization cost,
                       previously ``serving_wasted_block_tokens_total``)

The conservation law (test-asserted): within one tick, the kinds sum
exactly to the tick's total device tokens — decode rows
(``slots x tick_block``) + prefill launch rows (participating slots x
padded chunk width, or the dense segment + pad) + masked page DMAs
(token-equivalents). ``register_prefix`` prefill is operator setup, not
serving work, and stays OFF the ledger.

Where the port's device work differs from the reference's (the server
charges what the port's routes do; everywhere else the two ledgers are
equal, and ``tests/test_torch_goodput.py`` pins each difference):

- ``skipped_page_dma`` counts only pages the route taken really reads
  and masks. On the card every route reads no K/V column at or past a
  slot's frontier — K1's bf16 split body and its f32 body, K2's bodies
  and K3's, which walks the live-page schedule and skips its pad
  entries — so a server on the card charges none. The CPU plain
  versions gather each slot's whole block-table width: a split decode
  step and a ragged prefill launch charge ``(table width - live
  pages) x page_size`` for each live slot, the reference's model; a
  fused pass charges the same for each live slot of the pass, where the
  reference charges its schedule's ladder pad.
- A fused tick that carries prefill chunks AND decode rows runs the
  decode rows as a pass of their own at ``[S, 1]`` (so a decode row's
  bits do not depend on its tick's other rows): each decode row is one
  device token, with none of the reference's ``C - 1`` pad rows.
- ``chunk_pad`` is the reference's ``[S, C]`` ladder pad.

So on the port the law reads: decode rows + prefill launch rows + each
fused pass's rows (a prefill slot's chunk width, a decode slot's one
row) + masked page reads.

Cost contract (mirrors ``FlightRecorder``): ``add`` is a plain dict
bump under the server's own lock — no clock reads ever, no extra lock;
``flush_tick`` takes one short ledger lock to fold the tick into the
cumulative totals (cross-thread ``/stats`` reads). A DISABLED ledger
(``enabled=False``) is treated by the server exactly like ``None`` —
one attribute check on the hot path, zero locks, zero clock reads.

Published surfaces: ``server_tokens_total{kind}`` counter and the
per-tick ``serving_goodput_ratio`` gauge (when a registry is wired),
``snapshot()`` under ``/stats["goodput"]``, and a ``goodput`` section
in postmortem bundles.
"""
import threading

__all__ = ["GoodputLedger", "WASTE_KINDS", "TOKEN_KINDS"]

WASTE_KINDS = ("null_redirect", "chunk_pad", "skipped_page_dma",
               "replay", "tail_reprefill", "block_waste")
TOKEN_KINDS = ("goodput",) + WASTE_KINDS


class GoodputLedger:
    """Per-tick device-token attribution, folded into cumulative totals.

    >>> led = GoodputLedger(registry=tele.registry)
    >>> srv = ContinuousBatchingServer(model, ..., ledger=led)
    >>> srv.run()
    >>> led.snapshot()["goodput_ratio"]          # useful / total
    >>> led.totals()["replay"]                   # preemption burn

    The server calls ``add(kind, n)`` at each attribution site (under
    its own lock) and ``flush_tick()`` once per tick; everything else
    is read-side.
    """

    def __init__(self, registry=None, enabled=True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._tick = {}                      # current tick, single-writer
        self._totals = {}
        self._ticks = 0
        self._last = None                    # last flushed tick dict
        self._last_ratio = None
        self._tok = None
        self._tok_children = {}
        self._g_ratio = None
        if (self.enabled and registry is not None
                and getattr(registry, "enabled", False)):
            self._tok = registry.counter(
                "server_tokens_total",
                "Device tokens per tick by attribution kind "
                "(goodput / null_redirect / chunk_pad / "
                "skipped_page_dma / replay / tail_reprefill / "
                "block_waste) — kinds sum to total device tokens",
                labelnames=("kind",))
            self._g_ratio = registry.gauge(
                "serving_goodput_ratio",
                "goodput / total device tokens for the last non-empty "
                "tick (the fused-megakernel and speculative-decode "
                "success metric)")

    # ----------------------------------------------------------- write
    def add(self, kind, n):
        """Attribute ``n`` device tokens of this tick to ``kind``.
        Zero-count adds are dropped so a flushed tick's kinds are
        exactly the nonzero ones. No lock, no clock: callers already
        hold the server lock (single writer per ledger)."""
        if n:
            self._tick[kind] = self._tick.get(kind, 0) + int(n)

    def flush_tick(self):
        """Fold the current tick into the cumulative totals and publish
        metrics. Empty ticks (nothing attributed — an idle poll)
        publish nothing. Returns the tick's ``{kind: tokens}`` dict, or
        None when it was empty."""
        tick, self._tick = self._tick, {}
        if not tick:
            return None
        total = sum(tick.values())
        ratio = tick.get("goodput", 0) / total
        with self._lock:
            for k, n in tick.items():
                self._totals[k] = self._totals.get(k, 0) + n
            self._ticks += 1
            self._last = tick
            self._last_ratio = ratio
        if self._tok is not None:
            for k, n in tick.items():
                child = self._tok_children.get(k)
                if child is None:
                    child = self._tok_children[k] = \
                        self._tok.labels(kind=k)
                child.inc(n)
            self._g_ratio.set(ratio)
        return tick

    # ------------------------------------------------------------ read
    def totals(self):
        """Cumulative ``{kind: tokens}`` over every flushed tick."""
        with self._lock:
            return dict(self._totals)

    @property
    def ticks(self):
        return self._ticks

    def goodput_ratio(self):
        """Cumulative goodput / total device tokens (1.0 before any
        token was attributed — an idle server wastes nothing)."""
        with self._lock:
            total = sum(self._totals.values())
            if not total:
                return 1.0
            return self._totals.get("goodput", 0) / total

    def snapshot(self):
        """JSON-ready summary — the ``/stats["goodput"]`` payload and
        the ``goodput`` postmortem section."""
        with self._lock:
            totals = dict(self._totals)
            total = sum(totals.values())
            good = totals.get("goodput", 0)
            return {
                "tokens": totals,
                "total": total,
                "goodput_ratio": (good / total) if total else 1.0,
                "last_tick": dict(self._last) if self._last else None,
                "last_tick_ratio": self._last_ratio,
                "ticks": self._ticks,
            }
