"""Shared vision-stem helpers of the model zoo: port of
``paddle_tpu/models/_stem.py``.

``shard_params_by_name`` annotates parameters for ``auto_parallel``,
which the port does not have yet: it raises, naming ROADMAP Queue 1
item 13 (multi-card training), as ``shard_dit`` and ``shard_qwen_vl``
do through it.
"""

__all__ = ["patches_to_seq", "shard_params_by_name"]


def patches_to_seq(conv_out):
    """``[B, D, H/p, W/p]`` patch-embed output -> ``[B, T, D]`` tokens."""
    b, d = conv_out.shape[0], conv_out.shape[1]
    return conv_out.reshape(b, d, -1).transpose(1, 2)


def shard_params_by_name(model, process_mesh, mp_keys):
    raise NotImplementedError(
        "auto_parallel sharding (shard_params_by_name, shard_dit, "
        "shard_qwen_vl) is not ported yet (ROADMAP, Queue 1 item 13: "
        "multi-card training)")
