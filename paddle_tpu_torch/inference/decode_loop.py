"""The decode loops of ``generate()``, beam search, constrained (FSM)
decoding, ``scan_decode`` and the sampling filters.

Port of ``paddle_tpu/inference/decode_loop.py`` in plain torch (the
reference computes it in jnp, no ``pallas_call``). The reference scans
its steps on the device as one jitted program; here each loop is a
Python loop of eager steps over the same step functions, with no host
read inside it (tokens, eos flags, beam scores and automaton states stay
on the device until the end).

- ``greedy_generate`` and ``sample_generate``: the reference's scan runs
  ``max_new_tokens`` steps and discards the token of the last; the
  loops here skip that step, so the returned caches hold one row fewer:
  the tokens are the same.
- ``fsm_generate``: its final automaton states include the last step's
  token, so it runs every step the reference's scan runs.
- ``beam_generate``: ``max_new_tokens - 1`` steps over the ``B * K``
  beam rows, as the reference's scan; the top K of a step is a STABLE
  descending sort (the lower index first among equal values, as
  ``jax.lax.top_k``), since beams meet exact ties (``-inf`` pads when K
  exceeds the vocabulary, frozen beams).
- ``scan_decode``: ``steps`` calls of any step function, each output fed
  to the next, the caches as the step functions leave them.
- ``phrases_to_fsm``: the reference's numpy trie over phrases, copied.

``process_logits``: temperature, then top-k (every logit below the k-th
largest filled with ``-1e30``), then top-p (nucleus: the logits sorted
in descending order, stable, softmax'd and summed; a token is kept while
the probability mass before it is below ``top_p``, so the first always
is).
"""
import numpy as np
import torch

from ..core import prng
from ..core.random import categorical

__all__ = ["scan_decode", "greedy_generate", "sample_generate",
           "beam_generate", "fsm_generate", "phrases_to_fsm",
           "process_logits", "NEG"]

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


def scan_decode(step_fn, x0, caches, t0, steps, donate=True):
    """``steps`` iterations of ``step_fn(x, caches, t) -> (out, caches)``
    at positions ``t0 .. t0 + steps - 1`` (Python ints), each output the
    next step's input; returns ``(out, caches)`` after the last. Every
    step runs, so the caches hold every row the reference's scan writes.
    ``donate`` is accepted for the reference's signature: the port's step
    functions write their caches in place whatever it says."""
    del donate
    x = x0
    t = int(t0)
    for _ in range(int(steps)):
        x, caches = step_fn(x, caches, t)
        t += 1
    return x, caches


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


def _top_k(x, k):
    """(values, indices) of the k largest entries of x's last dim, in
    descending order with the lower index first among equal values
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_generate(embed_fn, step_fn, head_fn, caches, first_logits, t0,
                  max_new_tokens, num_beams, eos_token_id=None):
    """Beam search over the dense caches (``decode_loop.py:234-320``).

    Beams ride the batch dimension: the prefill ``caches`` (at batch B)
    are repeated to ``B * K`` rows; each step scores the ``K * V``
    continuations of a sequence (the running log-probability plus the
    step's f32 ``log_softmax``), keeps the top K (``_top_k``) and reorders
    the cache rows, done flags and histories by ancestry. A finished beam
    (its last token ``eos_token_id``) is frozen: its expansion is ``-inf``
    everywhere but eos, at zero cost. With K above the vocabulary the
    first step's missing beams start at ``-inf`` with token 0. Returns
    ``(ids [B, max_new_tokens] int32 of the best beam, scores [B, K])``,
    the best beam the first maximum of the final scores."""
    K = int(num_beams)
    B, V = first_logits.shape
    dev = first_logits.device
    logp0 = torch.log_softmax(first_logits.float(), -1)
    k0 = min(K, V)
    scores, tok = _top_k(logp0, k0)                       # [B, k0]
    if k0 < K:
        scores = torch.cat([scores, torch.full((B, K - k0), float("-inf"),
                                               device=dev)], 1)
        tok = torch.cat([tok, tok.new_zeros((B, K - k0))], 1)
    tok = tok.to(torch.int32)
    done = (tok == eos_token_id) if eos_token_id is not None \
        else torch.zeros((B, K), dtype=torch.bool, device=dev)
    caches = {n: c.repeat_interleave(K, dim=1) for n, c in caches.items()}
    hist = torch.zeros((B, K, max_new_tokens), dtype=torch.int32,
                       device=dev)
    hist[:, :, 0] = tok
    if eos_token_id is not None:
        frozen = torch.full((V,), float("-inf"), device=dev)
        frozen[eos_token_id] = 0.0
    base = (torch.arange(B, device=dev) * K)[:, None]
    t = int(t0)
    for step_i in range(1, max_new_tokens):
        out, caches = step_fn(embed_fn(tok.reshape(B * K), t), caches, t)
        logp = torch.log_softmax(_last_row(head_fn(out)).float(), -1)
        logp = logp.reshape(B, K, V)
        if eos_token_id is not None:
            logp = torch.where(done[:, :, None], frozen, logp)
        total = scores[:, :, None] + logp                     # [B, K, V]
        scores, flat = _top_k(total.reshape(B, K * V), K)
        beam_idx = flat // V                                  # ancestor
        tok = (flat % V).to(torch.int32)
        rows = (base + beam_idx).reshape(-1)
        caches = {n: c[:, rows] for n, c in caches.items()}
        done = torch.gather(done, 1, beam_idx)
        hist = torch.gather(hist, 1, beam_idx[:, :, None].expand_as(hist))
        hist[:, :, step_i] = tok
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
        t += 1
    best = torch.argmax(scores, dim=1)                        # [B]
    ids = hist[torch.arange(B, device=dev), best]
    return ids, scores


def fsm_generate(embed_fn, step_fn, head_fn, caches, first_logits, t0,
                 max_new_tokens, fsm_mask, fsm_next, start_state=0,
                 do_sample=False, key=None, temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None):
    """Constrained generation (``decode_loop.py:323-394``): the automaton's
    ``fsm_mask`` ``[S, V]`` (tokens allowed in each state) sets every
    other logit to ``-inf`` before the pick, and ``fsm_next`` ``[S, V]``
    moves each row's state by the token it picked (before the eos rule).
    Greedy takes the first maximum; ``do_sample=True`` draws
    ``categorical(sub, process_logits(masked))`` with the reciprocal
    temperature (the reference jits the whole loop), one key over the
    whole batch (one R2 launch a draw on the card), ``key, sub =
    split(key)`` before every pick, greedy ones too, from ``key`` (a CPU
    ``uint32 [2]`` key; None: ``PRNGKey(0)``). The tables may be numpy or
    torch; they are copied to the logits' device once. Every one of the
    reference's ``max_new_tokens`` steps runs, the last one's token
    discarded but its state kept. Returns ``(ids [B, max_new_tokens]
    int32, final_states [B] int32)``."""
    temperature, top_k, top_p = float(temperature), int(top_k), float(top_p)
    dev = first_logits.device
    mask_tab = torch.as_tensor(fsm_mask, device=dev).bool()
    next_tab = torch.as_tensor(fsm_next, device=dev).long()
    if key is None:
        key = prng.PRNGKey(0)

    def pick(logits, state, k):
        rows = torch.where(mask_tab[state], _last_row(logits).float(),
                           float("-inf"))
        if do_sample:
            return categorical(k, process_logits(rows, temperature, top_k,
                                                 top_p, reciprocal=True))
        return torch.argmax(rows, -1).to(torch.int32)

    B = first_logits.shape[0]
    key, sub = prng.split(key)
    state = torch.full((B,), int(start_state), dtype=torch.long, device=dev)
    tok = pick(first_logits, state, sub)
    state = next_tab[state, tok.long()]
    done = None if eos_token_id is None else tok == eos_token_id
    toks = [tok]
    t = int(t0)
    for i in range(max_new_tokens):
        out, caches = step_fn(embed_fn(tok, t), caches, t)
        key, sub = prng.split(key)
        nxt = pick(head_fn(out), state, sub)
        state = next_tab[state, nxt.long()]
        if done is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        tok = nxt
        if i < max_new_tokens - 1:
            toks.append(tok)
        t += 1
    return torch.stack(toks, dim=1), state.to(torch.int32)


def phrases_to_fsm(phrases, vocab_size, eos_token_id):
    """Build an (fsm_mask, fsm_next) automaton that forces the output to
    be exactly one of ``phrases`` (token-id sequences, e.g. a fixed set
    of tool names or labels) followed by eos — a trie over the phrases.
    State 0 is the root; the accept state allows only eos. Numpy tables,
    the reference's (``decode_loop.py:397-435``) entry for entry."""
    if not phrases:
        raise ValueError("phrases must be non-empty")
    for ph in phrases:
        if int(eos_token_id) in (int(t) for t in ph):
            raise ValueError(
                f"phrase {list(ph)} contains eos_token_id "
                f"({eos_token_id}); eos terminates phrases and cannot "
                f"appear inside one")
    states = [{}]              # state -> {token: next_state}
    accept = None
    for ph in phrases:
        cur = 0
        for tok in ph:
            nxt = states[cur].get(int(tok))
            if nxt is None:
                states.append({})
                nxt = len(states) - 1
                states[cur][int(tok)] = nxt
            cur = nxt
        # phrase end: route to the shared accept state
        if accept is None:
            states.append({})
            accept = len(states) - 1
        states[cur][int(eos_token_id)] = accept
    states[accept][int(eos_token_id)] = accept   # absorb
    S = len(states)
    mask = np.zeros((S, vocab_size), bool)
    nxt_tab = np.zeros((S, vocab_size), np.int32)
    for s, edges in enumerate(states):
        for tok, n2 in edges.items():
            mask[s, tok] = True
            nxt_tab[s, tok] = n2
    return mask, nxt_tab
