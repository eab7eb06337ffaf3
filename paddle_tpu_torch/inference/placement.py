"""Disaggregated prefill/decode placement.

Copied from ``paddle_tpu/inference/placement.py`` (no framework code).

The fleet stops being N interchangeable replicas and becomes a PLACED,
phase-specialized system: prefill-specialist replicas run ragged
prefill (the flexible-query-length kernel path) and ship finished
prompt pages to decode specialists over the existing page-frame
handoff, so long prefills stop stealing decode ticks and inflating
TPOT. This module holds the placement brain the router calls into:

- **roles** — ``replica_role()`` reads a replica's ``role`` attribute
  (local servers) or heartbeat digest (``RemoteReplica``), defaulting
  to ``"hybrid"`` for pre-role replicas so mixed-version fleets route
  safely;
- **phase routing** — ``request_phase()`` splits fresh prompts by
  length (short prompts decode-local, no pointless hop) and
  ``order_for_phase()`` rewrites a candidate order for the phase,
  with the full degradation ladder: prefill specialists first for
  long prompts but ANY serving replica as fallback, and decode
  candidates keep prefill specialists only when nothing else serves
  (all-specialists-down degrades to hybrid routing, never failure);
- **handoff targeting** — ``order_handoff_targets()`` ranks decode
  targets by prefix affinity over the existing sketches, then pool
  headroom (free + reclaimable cached pages), then load.

The pump that drives one pipelined handoff lives on the router
(``ReplicaRouter._run_handoff``) because it mutates routes; the
policy decisions all resolve here.
"""

ROLES = ("prefill", "decode", "hybrid")

__all__ = ["ROLES", "replica_role", "request_phase", "order_for_phase",
           "order_handoff_targets", "pool_headroom",
           "normalize_placement"]


def normalize_placement(name):
    """Validate a router ``placement=`` value. ``None``/"affinity" is
    the legacy load/affinity routing (returned as None so the router's
    hot path stays one ``is None`` check); ``"disaggregated"`` turns
    phase-aware placement on."""
    if name in (None, "affinity"):
        return None
    if name == "disaggregated":
        return "disaggregated"
    if name == "cross-datacenter":
        raise NotImplementedError(
            "placement='cross-datacenter' is not wired yet: the "
            "pipelined page handoff assumes one datacenter's flat "
            "network — a WAN hop needs bandwidth-aware frame "
            "scheduling (batch pages by link budget, overlap chunk "
            "streams behind prefill ticks) and locality-tiered "
            "specialist pools (the JAX package does not wire it "
            "either)")
    raise ValueError(
        f"placement must be None, 'affinity', 'disaggregated' or "
        f"'cross-datacenter', got {name!r}")


def replica_role(rep):
    """A replica's placement role, defaulting unknown/missing/legacy
    values to ``"hybrid"`` — the router must never KeyError routing a
    replica that predates roles."""
    role = getattr(rep, "role", None)
    return role if role in ROLES else "hybrid"


def request_phase(ids, min_prefill_tokens):
    """Which phase a FRESH prompt routes by: long prompts are prefill
    work (place on a specialist, hand off for decode), short prompts
    skip the hop and decode wherever they land."""
    n = int(ids.shape[0]) if hasattr(ids, "shape") else len(ids)
    return "prefill" if n >= int(min_prefill_tokens) else "decode"


def order_for_phase(order, replicas, phase):
    """Rewrite a router candidate order (already affinity/load sorted)
    for a placement phase.

    ``phase="prefill"``: prefill specialists first (stable within each
    group), every other serving replica kept as the degradation tail —
    an all-specialists-down fleet still serves, hybrid-style.

    ``phase="decode"``: prefill specialists are EXCLUDED while any
    non-prefill replica serves (decode work on a specialist defeats
    the point), but kept when they are all that remains — degraded
    beats down."""
    if phase == "prefill":
        pref = [i for i in order
                if replica_role(replicas[i]) == "prefill"]
        rest = [i for i in order if i not in pref]
        return pref + rest
    rest = [i for i in order
            if replica_role(replicas[i]) != "prefill"]
    return rest if rest else list(order)


def pool_headroom(rep):
    """Pages a replica could give a handed-off request RIGHT NOW: free
    pages plus reclaimable cached (prefix-tree) pages. 0 for a dense
    backend or an unreachable host — such a target sorts last, never
    crashes the scan."""
    try:
        bal = rep.pool_balance()
    except Exception:
        return 0
    if bal is None:
        return 0
    return int(bal[0]) + int(bal[3])   # free + cached


def order_handoff_targets(order, replicas, aff):
    """Rank decode-handoff targets: prefix affinity over the existing
    sketches first (the handed-off prompt's pages may already be
    cached there), then pool headroom (the pages need a home), then
    the incoming order (load). ``order`` should already be
    phase-filtered (``order_for_phase(..., "decode")``)."""
    head = {i: pool_headroom(replicas[i]) for i in order}
    pos = {i: k for k, i in enumerate(order)}
    return sorted(order,
                  key=lambda i: (-aff.get(i, 0), -head[i], pos[i]))
