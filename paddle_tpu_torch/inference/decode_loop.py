"""The decode loops of ``generate()`` and the sampling filters.

Port of ``greedy_generate``, ``process_logits`` and ``sample_generate``
from ``paddle_tpu/inference/decode_loop.py:96-231``, in plain torch (the
reference computes them in jnp, no ``pallas_call``). The reference
scans its steps on the device as one jitted program; here they are a
Python loop of eager steps over the same step functions, with no host
sync inside it (tokens and the eos flags stay on the device until the
end). The reference's scan runs ``max_new_tokens`` steps and discards
the token of the last; the loops here skip that step, so the returned
caches hold one row fewer: the tokens are the same.

``process_logits``: temperature, then top-k (every logit below the k-th
largest filled with ``-1e30``), then top-p (nucleus: the logits sorted
in descending order, stable, softmax'd and summed; a token is kept while
the probability mass before it is below ``top_p``, so the first always
is). The rest of the reference module (``scan_decode``, beam search,
constrained decoding) is ROADMAP Queue 1 item 12.
"""
import numpy as np
import torch

from ..core import prng
from ..core.random import categorical

__all__ = ["greedy_generate", "sample_generate", "process_logits", "NEG"]

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


def _last_row(logits):
    return logits[:, -1] if logits.dim() == 3 else logits


def greedy_generate(embed_fn, step_fn, head_fn, caches, first_token, t0,
                    max_new_tokens, eos_token_id=None):
    """Greedy generation: per step ``x = embed_fn(tok, t)``, ``out, caches
    = step_fn(x, caches, t)``, ``tok' = argmax(head_fn(out))`` (the first
    maximum). ``first_token`` [B] is the first new token (the argmax of
    the last prefill logits), ``t0`` the first decode position. Once a
    row has emitted ``eos_token_id`` (its first token included) the rest
    of it is eos. Returns ``(ids [B, max_new_tokens] int32, caches)``;
    the last step, whose token the reference discards, is not run."""
    tok = first_token.to(torch.int32)
    if max_new_tokens <= 0:
        return tok.new_zeros((tok.shape[0], 0)), caches
    done = None if eos_token_id is None else tok == eos_token_id
    toks = [tok]
    t = int(t0)
    for _ in range(max_new_tokens - 1):
        out, caches = step_fn(embed_fn(tok, t), caches, t)
        nxt = torch.argmax(_last_row(head_fn(out)), -1).to(torch.int32)
        if done is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        tok = nxt
        toks.append(tok)
        t += 1
    return torch.stack(toks, dim=1), caches


def sample_generate(embed_fn, step_fn, head_fn, caches, first_logits, t0,
                    max_new_tokens, key, temperature=1.0, top_k=0,
                    top_p=1.0, eos_token_id=None):
    """Seeded sampled generation: every token, the first drawn from
    ``first_logits`` [B, V] (the last prefill position) included, is
    ``categorical(sub, process_logits(logits))`` with ``key, sub =
    split(key)`` before each draw: ONE key over the whole ``[B, V]``
    batch (``core.random.categorical``: one R2 launch a draw on the
    card). The reference jits the whole loop, so its temperature is a
    multiply by the reciprocal in every draw, the first too
    (``reciprocal=True``). ``key`` is a CPU ``uint32 [2]`` key; its splits
    run on the host. Eos as in ``greedy_generate``. Returns ``(ids [B,
    max_new_tokens] int32, caches)``."""
    temperature, top_k, top_p = float(temperature), int(top_k), float(top_p)

    def sample(logits, k):
        rows = process_logits(_last_row(logits), temperature, top_k, top_p,
                              reciprocal=True)
        return categorical(k, rows)

    B = first_logits.shape[0]
    if max_new_tokens <= 0:
        return torch.zeros((B, 0), dtype=torch.int32,
                           device=first_logits.device), caches
    key, sub = prng.split(key)
    tok = sample(first_logits, sub)
    done = None if eos_token_id is None else tok == eos_token_id
    toks = [tok]
    t = int(t0)
    for _ in range(max_new_tokens - 1):
        out, caches = step_fn(embed_fn(tok, t), caches, t)
        key, sub = prng.split(key)
        nxt = sample(head_fn(out), sub)
        if done is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        tok = nxt
        toks.append(tok)
        t += 1
    return torch.stack(toks, dim=1), caches
