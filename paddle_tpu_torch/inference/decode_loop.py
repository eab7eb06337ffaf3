"""The sampling filters of the decode loop.

Port of ``process_logits`` from ``paddle_tpu/inference/decode_loop.py:
150-176``, in plain torch (the reference computes it in plain jnp, no
``pallas_call``): temperature, then top-k (every logit below the k-th
largest filled with ``-1e30``), then top-p (nucleus: the logits sorted
in descending order, stable, softmax'd and summed; a token is kept while
the probability mass before it is below ``top_p``, so the first always
is). The rest of the reference module (``greedy_generate``,
``sample_generate``) is ROADMAP Queue 1 item 12.
"""
import numpy as np
import torch

__all__ = ["process_logits", "NEG"]

NEG = -1e30


def process_logits(logits, temperature=1.0, top_k=0, top_p=1.0,
                   reciprocal=False):
    """Filtered f32 logits ``[..., V]`` ready for categorical sampling.

    ``reciprocal``: scale by the f32 reciprocal of the temperature instead
    of dividing by it. XLA rewrites a division by a constant into that
    product inside a jitted program, so the reference's jitted draws (the
    split decode step, the fused tick) multiply while its eager one (a
    split tick's first token) divides; the server asks for each where the
    reference does. The divisor is a tensor on the logits' device, so the
    card divides too (torch on CUDA multiplies by the reciprocal of a host
    scalar). The constants are made on the device or passed as Python
    numbers: nothing here copies from the host."""
    logits = logits.float()
    if temperature != 1.0:
        t = np.float32(max(temperature, 1e-6))
        if reciprocal:
            logits = logits * float(np.float32(1) / t)
        else:
            logits = logits / torch.full((), float(t), dtype=torch.float32,
                                         device=logits.device)
    if top_k and top_k > 0:
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG, logits)
    if top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1,
                                             descending=True, stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < float(np.float32(top_p))
        keep = torch.zeros_like(keep_sorted).scatter_(-1, sort_idx,
                                                      keep_sorted)
        logits = torch.where(keep, logits, NEG)
    return logits
