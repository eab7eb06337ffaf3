"""``paddle.static``'s collectives (``paddle_tpu/static/collective.py``):
not ported. Their tests run a four-rank mesh, which comes with
multi-card training (ROADMAP, Queue 1 item 13)."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"static.collective.{name} is not ported: the static collectives "
        "need a four-rank mesh (ROADMAP, Queue 1 item 13: multi-card "
        "training)")
