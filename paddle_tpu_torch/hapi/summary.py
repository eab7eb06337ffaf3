"""paddle.summary / paddle.flops parity (python/paddle/hapi/model_summary.py).

Port of ``paddle_tpu/hapi/summary.py`` over a torch module's named
parameters (a parameter is trainable when it requires a gradient)."""

__all__ = ["summary", "flops"]


def summary(net, input_size=None, dtypes=None):
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Param':<{width}}{'Shape':<20}{'Count':>12}"]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:>12,}")
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size=None, custom_ops=None, print_detail=False):
    """Rough analytic flops: 2 * params per token forward
    (matmul-dominated)."""
    total = sum(p.numel() for p in net.parameters())
    f = 2 * total
    if print_detail:
        print(f"~{f:,} FLOPs per sample forward (2*params estimate)")
    return f
