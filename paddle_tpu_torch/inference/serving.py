"""HTTP exposition of a serving stack's telemetry.

Port of ``serve_metrics`` from ``paddle_tpu/inference/serving.py``
(framework-free). The module's ``BatchScheduler`` is not ported yet
(ROADMAP Queue 1 item 12), nor is the router (item 9): a router target
raises.
"""
__all__ = ["serve_metrics"]


def serve_metrics(target, host="127.0.0.1", port=0):
    """Expose a serving stack's telemetry over HTTP: ``/metrics``
    (Prometheus text), ``/stats`` (JSON snapshot + process stats), and
    — when ``target`` reports health — ``/healthz`` (200 while serving,
    503 otherwise: the load-balancer readiness contract).

    ``target`` is a ``ContinuousBatchingServer`` (uses its attached
    ``telemetry``), a ``ServerTelemetry``, or a bare ``MetricRegistry``.
    Returns a started ``telemetry.MetricsServer`` (``.url``, ``.port``,
    ``.close()``). ``port=0`` binds an ephemeral port.

    Debug surfaces: a server target serves its captured bundles on
    ``/debug/postmortem`` (an empty list without a ``FlightRecorder``)
    and per-request journey timelines on ``/debug/journey/<rid>`` (a
    server constructed with ``journeys=``; 404 for unknown rids — every
    rid, without a ``JourneyRecorder``). ``/stats`` carries the pool's
    and the prefix cache's statistics, and the goodput ledger's and the
    cost catalog's snapshots under ``"goodput"`` and ``"costs"`` when
    the server wires them.
    """
    from ..telemetry.exposition import MetricsServer

    if hasattr(target, "replicas"):
        raise NotImplementedError(
            "serve_metrics of a router is not ported to paddle_tpu_torch "
            "yet (ROADMAP, Queue 1 item 9: the fleet)")
    extra = None
    tele = getattr(target, "telemetry", target)
    if tele is None:
        raise ValueError(
            "server has no telemetry attached — construct it with "
            "telemetry=True (or a ServerTelemetry) to expose metrics")
    registry = getattr(tele, "registry", tele)
    if hasattr(target, "stats"):          # ContinuousBatchingServer
        kv = getattr(target, "_kv", None)

        def extra():
            stats = dict(target.stats)
            if kv is not None:
                stats["kv_pool"] = kv.telemetry_stats()
                stats["prefix_cache"] = target._prefix.stats()
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
    return MetricsServer(registry, host=host, port=port,
                         extra_stats=extra, health=health,
                         journey=journey,
                         postmortem=postmortem).start()
