"""Deployable generation: prefill and a greedy decode step as
``torch.export`` archives.

Port of ``paddle_tpu/inference/deploy_decode.py``. The reference writes
two ``jax.export`` archives, a prefill and the whole greedy loop as one
scan program. The port writes, with the weights inside each:

- ``<prefix>.prefill``: ids ``[B, T]`` -> ``(first [B] int32, caches)``,
  the dense bundle's step at the constant offset 0;
- ``<prefix>.decode``: ONE step, ``(tok [B], caches, t [B]) -> (next [B],
  caches)``, at per-row positions ``t`` (a 0-d position would be read on
  the host, which export cannot trace), the caches written in place;
- ``<prefix>.genmeta``: the shape contract (``batch``, ``prompt_len``,
  ``max_new_tokens``, ``max_cache_len``), ``eos_token_id`` and
  ``weight_dtype``, ``"format": "paddle_tpu_torch-decode-v1"``.

``DeployedGenerator.generate`` loops the decode step on the host with
the reference scan body's eos rule (a row that has emitted eos emits eos
from then on). The reference's scan runs ``max_new_tokens`` steps and
discards the last one's token; the loop here skips that step, as
``greedy_generate`` does. A serving process needs the archives, torch and
``paddle_tpu_torch.ops.kernels`` (the custom ops), no model code.
"""
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..nn.layer import plain_parameters
from .export import _load_program, _read_meta, _save_program

__all__ = ["FORMAT", "export_decode", "load_decode", "DeployedGenerator"]

FORMAT = "paddle_tpu_torch-decode-v1"


class _Prefill(torch.nn.Module):
    """The prefill archive's program. The bundle's step functions run
    under ``torch.no_grad`` and read the weights through closures, which
    export lifts as constants: the model is held as a plain attribute
    (not a submodule), so the archive stores each weight once."""

    def __init__(self, model, bundle, batch):
        super().__init__()
        self._embed = model._prefill_embed
        self._bundle = bundle
        self._batch = batch

    def forward(self, ids):
        init_caches, _, step_fn, head_fn, _ = self._bundle
        out, caches = step_fn(self._embed(ids), init_caches(self._batch), 0)
        first = torch.argmax(head_fn(out[:, -1:])[:, -1], -1)
        return first.to(torch.int32), caches


class _DecodeStep(torch.nn.Module):
    """The decode archive's program: one greedy step (the weights as
    ``_Prefill``'s)."""

    def __init__(self, bundle):
        super().__init__()
        self._bundle = bundle

    def forward(self, tok, caches, t):
        _, embed_fn, step_fn, head_fn, _ = self._bundle
        out, caches = step_fn(embed_fn(tok, t), caches, t)
        logits = head_fn(out)
        if logits.dim() == 3:
            logits = logits[:, -1]
        return torch.argmax(logits, -1).to(torch.int32), caches


def export_decode(path_prefix, model, prompt_len, max_new_tokens,
                  batch=1, max_cache_len=None, eos_token_id=None,
                  weight_dtype=None):
    """Write this model's generation pipeline at fixed shapes (``batch``
    x ``prompt_len`` prompts, ``max_new_tokens`` outputs — static shapes
    are the deployment contract, like the reference's baked feed
    shapes), traced on the model's device. Returns the two archive
    paths."""
    if max_cache_len is None:
        max_cache_len = prompt_len + max_new_tokens
    elif prompt_len + max_new_tokens > max_cache_len:
        # a decode write past the cache is dropped: an undersized cache
        # would emit wrong tokens; fail like generate() does
        raise ValueError(
            f"prompt_len ({prompt_len}) + max_new_tokens "
            f"({max_new_tokens}) exceeds max_cache_len ({max_cache_len})")
    bundle = model._decode_bundle(max_cache_len, weight_dtype)
    dev = model.device
    ids = torch.zeros((batch, prompt_len), dtype=torch.int32, device=dev)
    tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
    t = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    caches = bundle[0](batch)
    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)), exist_ok=True)
    paths = []
    with torch.no_grad(), plain_parameters(model):
        for name, mod, args in (
                ("prefill", _Prefill(model, bundle, batch), (ids,)),
                ("decode", _DecodeStep(bundle), (tok, caches, t))):
            ep = torch.export.export(mod, args)
            path = f"{path_prefix}.{name}"
            _save_program(ep, path)
            paths.append(path)
    with open(path_prefix + ".genmeta", "w") as f:
        json.dump({"format": FORMAT, "batch": batch,
                   "prompt_len": prompt_len,
                   "max_new_tokens": max_new_tokens,
                   "max_cache_len": max_cache_len,
                   "eos_token_id": eos_token_id,
                   "weight_dtype": weight_dtype}, f)
    return tuple(paths)


class DeployedGenerator:
    """Runs an ``export_decode`` artifact on ``device`` (None: the card):
    ids ``[B, T]`` -> ``[B, T + N]`` (numpy int32)."""

    def __init__(self, path_prefix, device=None):
        self.device = resolve_device(device)
        self.meta = _read_meta(path_prefix + ".genmeta", FORMAT)
        self._prefill = _load_program(path_prefix + ".prefill",
                                      self.device).module()
        self._decode = _load_program(path_prefix + ".decode",
                                     self.device).module()

    @torch.no_grad()
    def generate(self, input_ids):
        if torch.is_tensor(input_ids):
            input_ids = input_ids.detach().cpu().numpy()
        ids = np.asarray(input_ids).astype(np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        B, T = ids.shape
        if (B, T) != (self.meta["batch"], self.meta["prompt_len"]):
            raise ValueError(
                f"archive serves shape ({self.meta['batch']}, "
                f"{self.meta['prompt_len']}), got ({B}, {T}) — export "
                f"per served shape (static-shape deployment contract)")
        eos = self.meta["eos_token_id"]
        tok, caches = self._prefill(torch.from_numpy(ids).to(self.device))
        # an eos-first prefill eos-pads the whole output, as generate()
        done = None if eos is None else tok == eos
        toks = [tok]
        t = torch.full((B,), T, dtype=torch.int32, device=self.device)
        for _ in range(self.meta["max_new_tokens"] - 1):
            nxt, caches = self._decode(tok, caches, t)
            if done is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done = done | (nxt == eos)
            tok = nxt
            toks.append(tok)
            t = t + 1
        new = torch.stack(toks, dim=1).cpu().numpy()
        return np.concatenate([ids, new], axis=1)


def load_decode(path_prefix, device=None):
    return DeployedGenerator(path_prefix, device=device)
