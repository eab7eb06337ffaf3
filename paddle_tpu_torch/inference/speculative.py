"""Speculative decoding: a small draft model proposes, the target model
verifies a whole block in one forward.

Port of ``paddle_tpu/inference/speculative.py``. Each round costs one
draft decode of ``gamma + 1`` steps plus ONE target forward over ``gamma
+ 1`` positions, and accepts ``k + 1`` tokens (the matched draft prefix
plus the target's own token at the first divergence). With greedy
acceptance the tokens are the target's own greedy decode: speculation
changes latency, not results, up to near-ties. The verify forward runs
its projections at ``gamma + 1`` rows where ``generate()`` runs them at
one, and torch's matmuls round by their row count (cuBLAS on the card,
and the CPU's too: a logit can move in its last bits), where the
reference's claim rests on XLA-CPU computing a row the same way at any
row count; so a near-tie can resolve the other way (ROADMAP Queue 3).

Cache discipline: neither model rolls anything back. Rejected draft
positions leave stale KV rows ABOVE the accepted frontier; the causal
mask of the dense bundle (``models.generation._cached_attend``: key
position <= query position) hides them, and the next round's feed
overwrites exactly those rows before they become visible. The draft runs
all ``gamma + 1`` steps the reference's scan runs, so it writes its row
``t + gamma``, which the next round reads when all ``gamma`` drafts were
accepted.
"""
import numpy as np
import torch

__all__ = ["speculative_generate"]


def speculative_generate(target, draft, input_ids, max_new_tokens=32,
                         gamma=4, eos_token_id=None, max_cache_len=None,
                         return_stats=False):
    """Greedy speculative decoding (single sequence).

    ``target`` and ``draft`` are causal LMs of the port sharing a
    vocabulary (any mix of GPT, Llama and Mixtral) on one device;
    ``gamma`` is the draft block length. Returns the full sequence
    (prompt + new tokens) as an int32 ``[1, T + max_new_tokens]`` tensor
    on the target's device: ``target.generate(input_ids,
    max_new_tokens, eos_token_id=...)``'s tokens, up to near-ties (module
    docstring); with ``return_stats=True`` also a dict of the rounds and
    each round's accepted drafts."""
    from .decode_loop import greedy_generate

    if torch.is_tensor(input_ids):
        input_ids = input_ids.detach().cpu().numpy()
    ids_np = np.asarray(input_ids).astype(np.int32)
    if ids_np.ndim == 1:
        ids_np = ids_np[None]
    if ids_np.shape[0] != 1:
        raise ValueError("speculative_generate is single-sequence; "
                         "batch via the continuous-batching server")
    T0 = ids_np.shape[1]
    if max_cache_len is None:
        max_cache_len = min(target.cfg.max_seq_len,
                            T0 + max_new_tokens + gamma + 1)
    if T0 + max_new_tokens + gamma + 1 > max_cache_len:
        raise ValueError(
            f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) + "
            f"gamma+1 ({gamma + 1}) exceeds max_cache_len "
            f"({max_cache_len}) — the verify block needs headroom")

    t_init, _, t_step, t_head, _ = target._decode_bundle(max_cache_len)
    d_init, d_embed, d_step, d_head, _ = draft._decode_bundle(max_cache_len)
    dev = target.device

    with torch.no_grad():
        # prefill both models on the prompt; the first token is the
        # target's
        ids = torch.from_numpy(ids_np).to(dev)
        out, t_caches = t_step(target._prefill_embed(ids), t_init(1), 0)
        a = int(torch.argmax(t_head(out[:, -1:])[:, -1], -1)[0])
        _, d_caches = d_step(draft._prefill_embed(ids.to(draft.device)),
                             d_init(1), 0)

        emitted = [a]
        t = T0                  # next feed position (token `a` sits here)
        accepts = []
        while len(emitted) < max_new_tokens and not (
                eos_token_id is not None and emitted[-1] == eos_token_id):
            # 1) the draft proposes gamma tokens from its own caches: the
            # reference's gamma + 1 scan steps emit [a, d1..dgamma] and
            # discard the last step's token; greedy_generate skips a
            # discarded last step, so ask it for one token more
            first = torch.tensor([emitted[-1]], dtype=torch.int32,
                                 device=draft.device)
            d_ids, d_caches = greedy_generate(d_embed, d_step, d_head,
                                              d_caches, first, t, gamma + 2)
            drafts = d_ids[0, 1:gamma + 1].cpu().numpy()  # gamma tokens

            # 2) one target forward over [a, d1..dgamma] at offset t
            block = np.concatenate([[emitted[-1]], drafts]).astype(np.int32)
            x = target._prefill_embed(
                torch.from_numpy(block[None]).to(dev), t0=t)
            out, t_caches = t_step(x, t_caches, t)
            m = torch.argmax(t_head(out), -1)[0].cpu().numpy()

            # 3) accept the matched prefix + the target's correction token
            k = 0
            while k < gamma and m[k] == drafts[k]:
                k += 1
            accepts.append(k)
            emitted.extend([int(d) for d in drafts[:k]] + [int(m[k])])
            t += k + 1
            # the draft's rows for accepted tokens were written while
            # drafting; the correction token is fed next round (as `a`).
            # Rows above the frontier are stale but masked (module doc).

    emitted = emitted[:max_new_tokens]
    if eos_token_id is not None and eos_token_id in emitted:
        # generate()'s contract: the tail after eos is eos
        emitted = emitted[:emitted.index(eos_token_id) + 1]
        emitted += [eos_token_id] * (max_new_tokens - len(emitted))
    full = np.concatenate([ids_np[0], np.asarray(emitted, np.int32)])
    result = torch.from_numpy(full[None]).to(dev)
    if return_stats:
        return result, {
            "rounds": len(accepts),
            "accepted_per_round": accepts,
            "mean_accepted": float(np.mean(accepts)) if accepts else 0.0,
            "tokens_per_target_forward":
                (len(emitted) / len(accepts)) if accepts else 1.0,
        }
    return result
