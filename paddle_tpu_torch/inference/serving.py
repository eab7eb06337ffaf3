"""HTTP exposition of a serving stack's telemetry.

Port of ``serve_metrics`` from ``paddle_tpu/inference/serving.py``
(framework-free), for a server and for a ``ReplicaRouter`` front door.
The module's ``BatchScheduler`` is not ported yet (ROADMAP Queue 1 item
12).
"""
__all__ = ["serve_metrics"]


def serve_metrics(target, host="127.0.0.1", port=0):
    """Expose a serving stack's telemetry over HTTP: ``/metrics``
    (Prometheus text), ``/stats`` (JSON snapshot + process stats), and
    — when ``target`` reports health — ``/healthz`` (200 while serving,
    503 otherwise: the load-balancer readiness contract).

    ``target`` is a ``ContinuousBatchingServer`` (uses its attached
    ``telemetry``), a ``router.ReplicaRouter`` (its ``/healthz``
    AGGREGATES the fleet: 200 iff >= 1 replica is serving, and ``/stats``
    carries per-replica health, queue, stats and utilization), a
    ``ServerTelemetry``, or a bare ``MetricRegistry``. Returns a started
    ``telemetry.MetricsServer`` (``.url``, ``.port``, ``.close()``).
    ``port=0`` binds an ephemeral port.

    Debug surfaces: server and router targets serve their captured
    bundles on ``/debug/postmortem`` (the router merges its own with
    every replica's; an empty list without a ``FlightRecorder``) and
    per-request journey timelines on ``/debug/journey/<rid>`` (minted at
    the router's front door, or by a standalone server constructed with
    ``journeys=``; 404 for unknown rids — every rid, without a
    ``JourneyRecorder``). ``/stats`` carries the pool's, the prefix
    cache's and the host tier's statistics, and the goodput ledger's and
    the cost catalog's snapshots under ``"goodput"`` and ``"costs"`` when
    the server wires them.

    Fleet surfaces: a router target serves ONE merged Prometheus page
    across every replica's registry on ``/fleet``
    (``router.fleet_metrics()``) and — with an ``SLOEngine`` attached
    (``ReplicaRouter(slos=...)``) — the burn-rate report on ``/slo``,
    whose worst state also rides the ``/healthz`` body as an ``"slo"``
    detail (the 200/503 verdict is unchanged).
    """
    from ..telemetry.exposition import MetricsServer

    extra = None
    tele = getattr(target, "telemetry", target)
    if tele is None:
        raise ValueError(
            "server has no telemetry attached — construct it with "
            "telemetry=True (or a ServerTelemetry) to expose metrics")
    registry = getattr(tele, "registry", tele)
    if hasattr(target, "replicas"):       # ReplicaRouter front door

        def extra():
            stats = dict(target.stats)
            stats["replicas"] = [
                {"health": rep.health,
                 "queue_depth": rep.queue_depth(),
                 "in_flight": rep.in_flight(),
                 "stats": dict(rep.stats),
                 "util": (rep.utilization()
                          if callable(getattr(rep, "utilization", None))
                          else {})}
                for rep in target.replicas]
            return stats
    elif hasattr(target, "stats"):        # ContinuousBatchingServer
        kv = getattr(target, "_kv", None)

        def extra():
            stats = dict(target.stats)
            if kv is not None:
                stats["kv_pool"] = kv.telemetry_stats()
                stats["prefix_cache"] = target._prefix.stats()
                tier = getattr(target, "_host", None)
                if tier is not None:
                    stats["host_tier"] = tier.stats()
            g = target.goodput()
            if g is not None:
                stats["goodput"] = g
            c = target.device_costs()
            if c is not None:
                stats["costs"] = c
            return stats
    health = None
    if hasattr(target, "health"):

        def health():
            return target.health
    journey = None
    if callable(getattr(target, "journey", None)):
        def journey(rid_s, _fn=target.journey):
            try:
                rid = int(rid_s)
            except (TypeError, ValueError):
                return None
            return _fn(rid)
    postmortem = getattr(target, "postmortems", None)
    if not callable(postmortem):
        postmortem = None
    fleet = getattr(target, "fleet_metrics", None)
    if not callable(fleet):
        fleet = None
    slo = slo_states = None
    if getattr(target, "slo_engine", None) is not None \
            and getattr(target.slo_engine, "enabled", False):
        slo = target.slo_report
        # /healthz reads the CACHED states; /slo scrapes are the only
        # evaluation driver
        slo_states = target.slo_engine.states
    return MetricsServer(registry, host=host, port=port,
                         extra_stats=extra, health=health,
                         journey=journey, postmortem=postmortem,
                         fleet=fleet, slo=slo,
                         slo_states=slo_states).start()
