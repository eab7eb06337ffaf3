#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only build,k1,k2,k3
    python3 chip_smoke.py --only build,k2,k7
    python3 chip_smoke.py --only build,k4,k5,train_parity,train
    python3 chip_smoke.py --only build,k6,train_parity,train
    python3 chip_smoke.py --only build,k4,k6,train_parity,train
    python3 chip_smoke.py --only build,k6,k7,k8,int8_parity
    python3 chip_smoke.py --only build,k5,k8,int8_parity,int8_infer,train
    python3 chip_smoke.py --only build,opt,train,train_amp
    python3 chip_smoke.py --only build,rng,parity
    python3 chip_smoke.py --only build,rng --parent build/parent
    python3 chip_smoke.py --only build,tensor_api --parent build/parent
    python3 chip_smoke.py --only build,train,fit
    python3 chip_smoke.py --only build,dense_parity,dense
    python3 chip_smoke.py --only build,preempt_parity,serve,preempt
    python3 chip_smoke.py --only build,serve,telemetry,fit
    python3 chip_smoke.py --only build,fleet_parity,fleet
    python3 chip_smoke.py --only build,serve,wire_parity,wire
    python3 chip_smoke.py --only build,serve,family_parity,families
    python3 chip_smoke.py --only build,serve,decode_parity,decoding,deploy
    python3 chip_smoke.py --only build,tensor_api
    python3 chip_smoke.py --only build,nn_layers
    python3 chip_smoke.py --only build,zoo_parity,zoo
    python3 chip_smoke.py --only build,tensor_api,static_jit
    python3 chip_smoke.py --only build,quant_parity,quant
    python3 chip_smoke.py --only build,moe_parity,moe,host
    python3 chip_smoke.py --only build,vision_parity,vision

Phases, in order; any failure exits non-zero:

1. card: name and power limit (nvidia-smi), TF32 switched off for
   float32 products and convolutions;
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc for
   sm_90a (one process per source, all at once), with ptxas's report;
   every time below is the card's own (``cuda_ms``: the wrapper's host
   work is hidden behind a spin kernel, and a sample it was not hidden
   from is dropped);
3. k1: the paged-decode kernel against its plain version at Llama-2-7B
   decode shapes and at Llama-2-70B's GQA head layout, bf16 and f32,
   within TOL and VEC_RTOL (below); a second launch bitwise equal; a
   poison check: every page that no slot's first ceil(min(len, T) / pg)
   table entries name filled with NaN must leave every output bit for
   bit unchanged; ptxas's registers and spills of the bf16 kernels; in
   bf16 at both head layouts its time beside the plain version's, one
   SDPA call over the gathered frame (a yardstick the port never calls)
   and its bound;
4. k2: the ragged-prefill kernel likewise, on 512-row chunks with
   prefix offsets, an idle slot and a chunk ending mid-page, at 7B's and
   70B's heads (both timed in bf16), then bf16 edge cases at full widths
   (C = 100, rep 4, head_dim 64 and 16, a slot ending at the table's last
   column), each with a poison check: every page past each slot's
   frontier and every unused column's page filled with NaN must leave the
   live rows bit for bit unchanged;
5. k3: the fused-tick kernel likewise, on an admission tick (512-row
   chunks at prefix offsets, two decode rows, an idle slot, a chunk
   ending mid-page) and a decode-only tick (C = 1, K1's lengths), each
   timed in bf16 at both head layouts (the decode-only tick beside K1),
   plus a poison check: every page the schedule does not list filled
   with NaN must leave the live rows bit for bit unchanged, and a second
   launch bitwise equal;
6. k4: the flash-attention forward (K4a) and backward (K4b: dq, then
   dk + dv) against their plain versions, bf16 and f32, at llama_350m's
   training shape (B = 8, S = 1024, 16 heads of 64, causal), at
   Llama-2-7B's (B = 1, S = 4096, 32 heads of 128, causal), non-causal,
   and at S = 1000 (a tail tile); at head_dims 32 and 96 (``nn``'s
   256- and 768-wide attention over 8 heads, B = 8, S = 1024, causal);
   then bf16 at S = 100, at S_q != S_k (non-causal and causal; also at
   head_dim 96) and at head_dim 16: o, lse, dq, dk, dv within TOL and
   VEC_RTOL; two backward runs bitwise equal; ptxas's registers and
   spills of the three bf16 kernels at each head_dim; then bf16
   non-causal at the zoo's shapes (DiT-S/4's 256 x 6 heads x 64 tokens,
   ViT-L/14's 4 x 16 heads x 256) and causal at moe_350m_8e's training
   step (8 x 12 heads x 1024 of 64); at the 350m, 7B, hd32, hd96 and the two
   zoo shapes, forward, backward and both timed beside the plain version,
   one SDPA call (a yardstick the port never calls) and the bound, the
   kernels' time also read from torch.profiler;
7. k5: RMSNorm forward (K5a) and backward (K5b) likewise, at 8192 x 1024
   (llama_350m), 4096 x 4096 (Llama-2-7B), 1000 x 264 and 8192 x 768
   (moe_350m_8e) rows x d, the backward bitwise repeatable; ptxas's registers and spills of the three
   kernels; in bf16 at the first two shapes timed beside
   torch.nn.functional.rms_norm, the backward's row kernel and its dw
   reduction also read apart from torch.profiler;
8. k6: the rope kernel, forward (sign +1) and backward (sign -1), bf16
   and f32 x under f32 and bf16 tables, against its plain version, the
   reference's composition, bit for bit (and within TOL and VEC_RTOL):
   one tensor at llama_350m's q (8 x 1024 x 16 x 64), Llama-2-7B's q (1 x
   4096 x 32 x 128) and a tail (S = 1000); q and k in one launch at
   llama_350m (16 + 16 heads), 7B (32 + 32), Llama-2-70B's GQA heads
   (64 + 8 of 128, S = 1024) and moe_350m_8e (12 + 12 of 64, its 1024-row
   table); the scalar body at D = 72 and on an offset
   view; every case launched twice into NaN-poisoned outputs, bitwise
   equal, on its stated route; ptxas's registers and spills of every
   instantiation; at 350m and 7B in bf16 (f32 tables, the train path's)
   the single-tensor and q + k launches timed beside the plain versions
   and their bytes bounds; then ``apply_rotary_kernel`` and
   ``apply_rotary_qk_kernel`` forward and backward under bf16 tables: two
   launches each (the kernel's route) and the plain version's values;
9. k7: the fused GEMM epilogue forward, and its backward through
   autograd, against the plain version at GPT-2 345M's FFN (4096 rows:
   1024 -> 4096 + bias, gelu; 4096 -> 1024 + bias), Llama-2-7B's gate
   projection (4096 x 4096 @ 4096 x 11008), relu, an N tail (N = 1000)
   and ragged shapes, bf16 and f32, each on its stated route (wgmma,
   mma.sync for K and N odd, simt for f32), timed beside torch.addmm +
   the activation (a yardstick the port never calls); then the GPT-2 FFN
   forward and backward through
   ``incubate.nn.functional.fused_linear_activation`` and
   ``fused_matmul_bias``, counters zeroed just before and read after,
   both launches on the wgmma route;
10. k8: the int8 matmul against its plain version, bit for bit in f32
   and bf16 out, at Llama-2-7B's projection shapes with 4096 rows (K x N
   4096 x 4096, 4096 x 11008, 11008 x 4096, 4096 x 32000), a decode batch
   (M = 8), M, K and N past the wgmma tile and ragged shapes, each on
   its stated route (wgmma; mma.sync for K and N off TMA's multiples),
   the 7B shapes also through the K-major entry the int8 layers call;
   every case launched twice into an output poisoned with NaN, bitwise
   equal; ptxas's registers and spills of both routes' kernels; the main
   path's entry (K-major, bf16 out) at 7B gate/up timed beside
   torch._int_mm + the same epilogue (a yardstick), with bf16
   torch.addmm and K7 at the same shape printed;
11. opt: the optimizer's fused step (``multi_tensor_adam``, the
   counterpart of the reference's jitted multi-tensor update) first on
   ragged, one-element and misaligned tensors packed between NaN gaps
   beside a tensor that is not live, f32, bf16, bf16 with masters and a
   mixed set, with and without the global-norm clip: every buffer bit for
   bit the plain version's on the CPU; then over llama_350m's 219
   parameter shapes (373,867,520 elements, seeded gradients at 1e-3 so
   ClipGradByGlobalNorm(1.0) is active) for bf16 parameters, bf16 with
   f32 masters and f32, each with and without the clip, 3 AdamW steps:
   against the plain version on the card by ROADMAP Queue 3's Adam rule
   (fed the kernel's clip scales; the scale itself within 4 f32 ulps of
   the plain one), a cut of the tensors bit for bit the plain version on
   the CPU, a second run bitwise equal, the kernels a step (1, or 3 with
   the clip); timed beside the per-leaf chain (which it must beat) and
   torch._fused_adamw_ (a yardstick the port never calls), with the
   bytes bound;
12. rng: the random kernels against their plain versions on the card
   (``core.prng``'s int64 threefry, itself ``jax.random`` bit for bit on
   the CPU). First ptxas's registers and spills of R1's and R2's kernels
   and, from ``cuobjdump -sass`` of the built libraries, the instructions
   an element of each kernel's busiest loop by class (alu: the integer ALU;
   imad: IMAD and VIADD on the FMA pipe; fp32; fp64; uniform; other), which
   the kernels' own bounds below use with the card's rates (SMs x lanes x
   the maximum SM clock; issue slots too). R1 (``sample_rows``, the serving
   tick's seeded draw): 1024 rows at V = 32000 (raw rows bf16) and at V =
   128256 (raw rows f32), fresh and carried keys, emitting and not, edge
   seeds, NaN, Inf and filtered rows, a NaN only in the raw rows: tokens,
   keys out and non-finite flags equal, a second launch equal; then its
   many-block plan at S = 1, 8 and 64 and V = 32000 and 128256 (raw bf16,
   f16, f32) with ties planted across block boundaries, NaNs in several
   chunks and the maximum and a raw NaN in the last chunk: two launches
   into outputs poisoned with NaN bits, one with keys_out aliasing keys and
   one on the scalar route (an unaligned view), all bitwise the plain
   version's and the planted tokens and flags. R2 (``threefry_fill``): keep
   masks bit for bit (p in 0.9, 0.5, 0, 1), the Gumbel noise (jax's and
   gumbel_softmax's) within RNG_ULPS of ``max(|g|, 1)``, at shapes up to 8
   x 1024 x 16 x 64 and a tail of 7 x 1001; dropout in f32, bf16 and f16
   with p in 0, 0.1, 0.5 (both modes) and 1: the forward and its saved
   bits, launched twice, and the vjp from those bits, bit for bit (a NaN
   matching any NaN), over full and broadcast masks (dropout2d's channels,
   a 7 x 1001 tail, an unaligned view on the scalar route, the wide route
   forced on small values, llama_350m's attention output and hidden state),
   each on its stated route. Then the times at the main path's shapes, each
   beside its bound (bytes, or the least instructions the function needs,
   NEED, over their pipes' rates), the bound of the kernel's own SASS
   counts, the plain version and the yardstick, each timed call's outputs
   then bit for bit the plain version's; and, given ``--parent`` (a ``git
   archive`` of a parent tree unpacked in a directory git ignores), the
   parent's kernels imported as ``ptt_parent`` in the same call (change,
   parent, change, parent): R1 at 1 x 32000, 8 x 32000, 8 x 128256 and 1024
   x 32000 beside torch.argmax (greedy's cost); R2's dropout at
   llama_350m's attention output forward with its saved bits and backward
   from them, the (8, 1, 1024) mask over 8 x 1024 x 1024 and dropout2d at 8
   x 64 x 32 x 32, beside torch.nn.functional.dropout (Philox: another
   mask, a yardstick the port never calls), and ``gumbel`` at 8 x 32000.
   Then R2's path, the counters zeroed before and read after: attention
   with dropout while training at llama_350m's shape
   (``scaled_dot_product_attention(dropout_p=0.1)``, forward and backward),
   ``dropout`` of a hidden state forward and backward and a hard
   ``gumbel_softmax``: 4 dropout launches (two forwards, two backwards from
   the saved bits), 1 draw, no other kernel; the outputs bit for bit the
   plain version's under the same keys (the attention's and the hidden
   state's forward, the hidden state's gradient) and the one-hot at the
   plain noise's argmax. Each kernel's ``max_abs_err`` is the largest
   |kernel - plain| over all of this;
13. parity: a llama_tiny-shaped float32 model served on the card (the
   kernels) and on the CPU (the plain versions) from the same weights,
   on split ticks and on fused ticks, must emit equal greedy tokens:
   card == CPU on each, and fused == split; split runs launch K1 and K2
   only, fused runs K3 only; then a seeded sampled wave of each
   (temperature 0.8, top_k 20, top_p 0.9; explicit seeds, edge seeds
   and the default rule past 2**31): card == CPU on each, one R1 launch
   a draw on the card;
14. dense_parity: the dense paths of the parity phase's llama_tiny-shaped
   float32 model on the card and on the CPU from the same weights,
   through the parity phase's two waves: the dense backend
   (``cache_backend="dense"``) and the paged pool with
   ``prefill_mode="dense"`` with a 12-token ``register_prefix`` (one page
   and a tail, registered twice) shared by the second wave, each greedy
   and sampled (the parity seeds), at ``tick_block`` 1 and 3; the paged
   pool with its default ragged prefill (5 prompt tokens a tick) at
   ``tick_block`` 3 with the same prefix (pinned tree pages), greedy and
   sampled, so slots parked mid-prefill at the ``max_cache_len``
   sentinel ride K1's block steps past the table; then ``generate`` at
   B = 3, greedy and sampled, whole and chunked. Card tokens must equal
   the CPU's in every mode; on the card the dense backend launches no
   K1, K2, K3 or R2, the pool K1 once a decode step and layer and no K3
   or R2, K2 none under dense prefill and once a layer of each ragged
   prefill launch, R1 once a server draw, and ``generate(do_sample=
   True)`` one R2 fill a draw and nothing else (greedy nothing); pools
   drain to ``live == 0`` with the prefix's page pinned; no launch at all
   on the CPU;
15. preempt_parity: optimistic admission and preemption on the parity
   phase's llama_tiny-shaped float32 model, on the card and on the CPU
   from the same weights: ``tests/test_torch_preemption.py``'s six
   prompts (4-11 tokens, seed 3), 24 new tokens each, 4 slots over a
   9-page pool of 8-token pages (every optimistic wave preempts),
   ``headroom_pages=1``, 6 prompt tokens a tick; optimistic split, fused
   and sampled split (temperature 0.8, top_k 20, top_p 0.9) waves and a
   reserve split wave at the same pool, each request streaming through
   ``on_token``. Card tokens must equal the CPU's in every mode and the
   optimistic greedy tokens the reserve wave's; ``preemptions`` >= 1 and
   equal on the card and the CPU (so are resumes, grown and headroom
   pages); every pool ends ``live == 0``, ``preempted == 0`` and
   ``free + pinned + cached == num_pages - 1``; every stream,
   concatenated, is its result (no chunk re-sent); on the card split
   waves launch K1 and K2 only, fused K3 only, R1 once a draw, and the
   CPU launches nothing;
16. train_parity: llama_tiny in float32 trained 3 steps (``train_step_fn``
   + ``AdamW``) on the card and on the CPU from one set of weights:
   per-step losses, step-1 gradients and the trained weights agree, and
   every step launches K4 forward, dq and dk + dv once per layer, K5
   forward and backward 2 x layers + 1 times, K6's q + k launch 2 x
   layers times (forward and backward) and the fused AdamW step once (one
   kernel) on the card, where the CPU runs its plain version; then again
   with rope on the composition (``ops.rope._COMPOSITION_ONLY``), no K6
   launch;
17. int8_parity: a llama_tiny-shaped float32 model converted by
   ``to_int8_inference`` on the card (K8) and on the CPU (the plain
   version) from the same weights: equal int8 codes (every layer's
   K-major ``qweight_t``) and scales, logits within one
   quantisation step of the head, equal greedy argmax, and 7 x layers + 1
   K8 launches per forward (and K6's q + k launch once a layer: the
   forward passes no ``position_ids``);
18. serve: Llama-2-7B in bf16 (random weights from a seed, full width
   and depth) serves 8 requests through ``ContinuousBatchingServer``,
   on split and on fused ticks, greedy and sampled, in the order split,
   fused, sampled split, sampled fused, each once (the reversed second
   pass was cut to make room for the moe phases; a new server over the
   same model each time, the last one freed first); the launch counters are zeroed just before each
   wave and read just after, and must equal decode ticks x layers (K1)
   and prefill launches x layers (K2) on a split wave, fused passes x
   layers (K3) on a fused wave (a tick with prefill chunks and decode
   rows runs the decode rows as a pass of their own), no K6 (serving
   passes ``position_ids``: rope is the composition); the sampled waves (temperature 0.8, top_k
   50, top_p 0.95, default seeds) with the same gates plus R1: one
   launch a fused tick, one a decode tick and one a completing prefill
   launch on split ticks; then one split and one fused admission tick,
   and five decode ticks of each (greedy and sampled), under
   torch.profiler, with the attention kernels' device time per tick;
19. dense: the serve phase's Llama-2-7B in bf16 through the dense paths.
   ``generate`` of 4 x 512-token prompts, 64 new tokens, greedy, sampled
   (temperature 0.8, top_k 50, top_p 0.95) and greedy with
   ``prefill_chunk=256``: wall, tokens/s, TTFT (a 1-token generate),
   TPOT and peak memory, the counters zeroed just before and read just
   after (sampled: one R2 fill a draw, nothing else, and R2's [4, V]
   noise under each of the 64 draws' keys bit for bit equal to its plain
   version; greedy: nothing).
   Then the dense server and the paged server with ``prefill_mode=
   "dense"`` (8 slots, max_cache_len 2048, the serve phase's 8 prompts
   behind a 256-token prefix, 32 new tokens), greedy at ``tick_block`` 1
   and 4 and one sampled wave of each, the paged ones with the prefix
   registered (16 pinned pages, every prompt hitting it), each
   configuration once (its second, reversed pass was cut to make room
   for the moe phases): wall,
   tokens/s, the median decode-only tick and TPOT, TTFT median and max,
   peak memory, beside the serve phase's paged ragged numbers; the
   dense_parity gates, finite live logits and a drained pool; then one
   profiled dense decode tick;
20. preempt: optimistic admission on the serve phase's Llama-2-7B in
   bf16 (full width and depth): 8 slots x 2048 tokens, 16-token pages,
   512 prompt tokens a tick, ``headroom_pages=1``; 12 requests (seeded
   prompts of 128-512 tokens, 64 new tokens each (cut from 128, then 96,
   to keep the whole script within its time; 2 preemptions a wave remain),
   each streaming
   through ``on_token``) over a pool sized so that reserve admission
   holds at most 4 requests at once (the 5 smallest full extents do not
   fit together; the size is printed). Four waves, each through the
   supervised ``start()`` / ``wait()`` / ``stop(drain=True)`` loop:
   reserve split, then optimistic split, fused and sampled split
   (temperature 0.8, top_k 50, top_p 0.95). Printed beside the card's
   name and power limit for each: wall, tokens/s, the median
   decode-only tick, TTFT median and max, mean decoding slots a tick,
   preemptions, resumes, pages grown and the launches of K1, K2, K3 and
   R1. Gates: 96 in-vocabulary tokens each; no non-finite live logits;
   no tick failed; every optimistic wave preempts at least once; the pool
   ends ``live == 0``, ``preempted == 0`` and ``free + pinned + cached ==
   num_pages - 1``; K1 == decode ticks x layers and K2 == prefill
   launches x layers on split waves, K3 == fused passes x layers on the
   fused wave, R1 == the draws on the sampled wave (none on greedy
   waves), no K6 or R2; every ``on_token`` stream is its ``wait()``
   result: each position sent once and every chunk a prefix of the
   result, so a replay redrew the tokens its request was parked with
   (the streams that disagree are printed before the gate fails).
   Informational: the optimistic greedy tokens against the reserve
   wave's;
21. telemetry: the port's telemetry on the serve phase's Llama-2-7B,
   prompts and 32 new tokens: for split and for fused ticks, one wave
   without telemetry and one with it, in that order, each on a new
   server, then a sampled fused wave on, "on"
   being ``telemetry``, ``recorder``, ``ledger``, ``journeys`` and a
   ``CostCatalog`` on the card's data-sheet peaks, each driven tick by
   tick. Gates: every wave's tokens (256 of 256) and K1, K2, K3 and R1
   launches equal its mode's "off" wave's (the sampled wave's
   tokens the serve phase's sampled fused wave's), serve's launch
   gates; the ledger's kinds sum to the rows each tick's launches ran
   (the server's ``device_rows``, counted from the host arrays it
   packs; no masked page read on the card), goodput = the
   prompt rows + 8 x 31 decode rows; the ``serving_ttft_seconds`` and
   ``serving_tpot_seconds`` histograms count the 8 requests, each
   median in the buckets of the smoke's own median (its clock reads
   bracket the server's; TPOT is a request's mean over its decode
   tokens); the catalog's roofline ratio <= 1.05
   on every tick; ``/metrics`` (parsed by ``parse_prometheus``) and
   ``/stats`` (with ``goodput`` and ``costs``) from ``serve_metrics``
   on the loopback interface during a ``start()`` wave; one postmortem
   bundle, whose pool balance adds up, from a request failed by an
   injected ``server.prefill`` fault; the tracer, mirrored into
   ``torch.profiler.record_function``, puts the server's request spans
   among a profile's events. Printed: each wave's tokens/s (over the
   time spent in the server's ``submit`` and ``step`` calls) and median
   decode-only tick, on against off; the phase split
   of the first
   admission tick and of a steady decode tick, the ledger's kinds and
   goodput ratio, each op's FLOPs, bytes, MFU and roofline ratio over
   its launch phase's seconds;
22. fleet_parity: llama_tiny in f32 on the card against the same scripts
   on the CPU (weights from seed 3): a request moved mid-decode between
   two port servers (``migrate_out`` / ``migrate_in``, every page's
   sha256 checked on arrival), split and fused, greedy and sampled; a
   session spilled to the host tier by later sessions and restored on
   its next turn; a disaggregated handoff (a prefill specialist and a
   decode replica behind ``ReplicaRouter(placement="disaggregated")``);
   a kill with failover. Gates: the card's tokens equal the CPU's in
   every scenario; each equals its never-migrated, never-evicted or
   single-replica run (a flushed partial is a prefix of it); zero
   re-prefill on each target; no request fails; live == 0 on every
   pool; the card's launches of K1 and K2 (split), K3 (fused) and R1
   (sampled) > 0, none on the CPU;
23. fleet: the in-process fleet on Llama-2-7B in bf16 (the serve phase's
   model): paged ragged replicas sharing its weights, each with the
   serve geometry (8 slots x 2048 tokens, 16-token pages, 512 prompt
   tokens a tick), behind ``ReplicaRouter``. Affinity: the serve
   prompts behind a 256-token prefix; after a donor, all 7 route to its
   replica (7 affinity hits, prefix hit tokens); the router's host ms a
   submit. Failover: 12 more such requests (all on the donor's replica:
   8 in its slots, 4 queued), ``kill()`` once a slot decodes: the queued
   ones complete on siblings, the partials flush, no request fails,
   live == 0 on every replica, the corpse too; ``serve_metrics(router)``
   ``/healthz`` 200, then 503 after ``stop()``. Migration: a 900-token
   request moved A -> B after 8 tokens, split and fused, greedy and
   sampled: its stream equals the never-migrated run's, B prefills 0
   tokens, every page passes its sha256; migrate_out and migrate_in ms,
   and the parts (gather, host copy, sha256, scatter) with pages, MiB
   and GB/s. Host tier: a 130-page pool where three 1000-token sessions
   spill the first, whose next turn restores it: tokens equal the
   never-evicted run's, spill and restore GB/s. Disaggregated: one
   prefill specialist and two decode replicas against a hybrid fleet of
   three on the serve prompts: every prompt of >= 256 tokens handed off,
   0 rows prefilled for them on their targets, the handoff latency
   (pump start to commit), the token agreement with the hybrid fleet
   (informational: chunk shapes differ), both fleets' tokens/s. Every
   wave's launches: K1 == decode ticks x layers and K2 == prefill
   launches x layers over its split replicas, K3 == fused passes x
   layers over its fused ones, R1 == the draws, no K6 or R2;
24. wire_parity: llama_tiny in f32 (weights from seed 3) served through
   the wire: ``ReplicaHost``s on threads of this process, their servers
   on the card, behind ``RemoteReplica``s and a round-robin
   ``ReplicaRouter``; the same script on the CPU. Waves of four prompts,
   split and fused, greedy and sampled, submitted before the replicas
   start; one request moved A -> B mid-decode over the wire (page
   frames sha256-checked by the transport and by the target), split and
   fused; a polite ``kill`` of a host holding queued work. Gates: the
   card's tokens equal the CPU's in every scenario; the moved request
   equals its never-moved run with zero re-prefill on B; the killed
   host's queue completes on its sibling, no request fails; live == 0
   on every pool, read over the wire; each wave's launches
   (``fleet_launch_gates``) from the hosts' servers' stats; none on the
   CPU;
25. wire: Llama-2-7B bf16 (full width and depth, seed 0) in two
   replica processes started together by ``spawn_replica_host``
   (``wire_factory``: the serve geometry, split, and serve_timed's warm
   request before the host listens). Prints each child's start time,
   the parent's ``torch.cuda.mem_get_info()`` and every process's use
   (``nvidia-smi --query-compute-apps``). Parity: each child takes the
   serve prompts before its serve loop starts: greedy tokens equal the
   serve phase's split wave, 256 of 256 (a reference wave in this
   process when serve is not run). Move: the fleet phase's 900-token
   request from A to B after 8 tokens over the wire (57 page frames of
   exactly 8 MiB): its tokens equal its never-moved run on B; printed:
   the gather, every side's sha256, the scatter, the socket and host
   copies, end to end. Digests: the longest gap between two digests the
   router's clients received while both hosts served (gated below the
   clients' ``draining_after_s``). Drill (``RouterSupervisor``, a router
   with journeys and ``serve_metrics``): A holds queued and mid-decode
   requests; A is frozen (SIGSTOP) until its client reads it ``dead``
   with its connection still open (stale digests alone), then
   SIGKILLed. Gates: the queued requests complete on B with full
   budgets, the mid-decode ones return exactly their streamed partials,
   B ends with live == 0, a failed-over request's journey spans two
   pids in ``export_fleet_trace``, ``/healthz`` answers 200 while B
   serves. B is then stopped and shut down: its launch counts, written
   at exit by the factory's ``atexit`` hook, pass ``fleet_launch_gates``
   against its own stats with K1 + K2 > 0;
26. family_parity: gpt2_tiny, mixtral_tiny and llama_tiny in float32
   (weights from seed 3) served on the card and on the CPU with the same
   weights: paged split and fused waves, greedy and seeded sampled, then
   split and fused with ``weight_dtype="int8"``, then the dense server
   with ``cache_dtype="int8"``; the card's tokens equal the CPU's on
   every wave; K1 and K2 launched on split waves, K3 on fused ones, R1
   once a draw, no kernel on the dense waves, nothing on the CPU;
27. families: GPT-2 345M (full width and depth) and Mixtral-8x7B's
   widths at 8 of its 32 layers (one card holds 8 layers in bf16 beside
   their int8 copy and the serve phase's 7B model), bf16 from seed 0,
   each on 8 slots x 1024 tokens (GPT-2's position table), 16-token
   pages, 512 prefill tokens a tick, 8 prompts of 100-700 tokens, 32 new
   tokens each: paged split and fused waves in bf16, then a split wave
   with int8 weights (and for GPT-2 a dense-server wave with an int8
   cache); then the serve phase's Llama-2-7B with int8 weights on its
   prompts, split and fused. Each wave: TTFT, TPOT, tokens/s and peak
   memory; gates as the serve phase's (launches = ticks x layers, the
   pool drained) plus, for int8, the bundle's weight bytes within 2% of
   half the bf16 projections' and the first token's logits within the
   rule of ``tests/test_generation.py`` (max |int8 - bf16| under 5% of
   max |bf16 logit|); int8 against bf16 token agreement printed. A
   profiled decode tick of GPT-2 and Mixtral in bf16 and int8, and K1,
   K2 and K3 alone at GPT-2's heads (16 of 64) and Mixtral's (32 over 8
   of 128), each held against its plain version and timed beside it,
   SDPA and its bound;
28. decode_parity: gpt2_tiny, mixtral_tiny and llama_tiny in float32
   (weights from seed 3, a weak draft from seed 4, copied to the card),
   on the card and on the CPU: ``beam_generate`` at K = 1 and 3, FSM
   greedy and seeded sampled ``generate(fsm=)`` over a phrase trie,
   ``speculative_generate`` with a perfect and a weak draft, 6 steps of
   ``scan_decode``; the card's tokens, acceptance, beam scores and
   ``scan_decode`` output and caches (within 1e-4) equal the CPU's; R2
   launched once a sampled FSM draw and nothing else on the card; then a
   ``BatchScheduler`` over llama_tiny's forward on the card gives each
   one-row result within 1e-4;
29. decoding: the serve phase's Llama-2-7B in bf16: ``generate(
   num_beams=4)`` over 2 prompts of 512 tokens, 32 new each, and
   ``beam_generate`` at K = 1 against ``generate()`` greedy; FSM greedy
   and seeded sampled over ``phrases_to_fsm`` of 8 phrases of 4-12
   tokens (every row a phrase and an eos tail); ``speculative_generate``
   (gamma 4, 64 new tokens, a 512-token prompt) with a weak draft (its
   widths at 2 layers, seed 1) and a perfect one (the target), against
   ``generate()`` greedy. Every card-against-card token comparison keeps
   the near-tie rule (``near_ties``): a run may leave its yardstick only
   where the yardstick's top-2 logit gap is within TOL["bfloat16"] of
   that row's max |logit|, each such position printed. ms a token of
   each path, speculative's rounds and acceptance;
30. deploy: ``torch.export`` archives on the card in a temporary
   directory removed at the end: ``export_layer`` of llama_tiny, of its
   ``to_int8_inference`` copy and of a bf16 fused linear, each archive's
   output equal to the eager card output and a run's launches those of
   the custom ops (K4a, K5a, K6 q + k; K8; K7); ``export_decode`` of
   llama_tiny equal to the card's ``generate()``; GPT-2 345M in bf16
   (full width, seed 0): ``export_decode`` of its first ``DECODE_LAYERS``
   (4) layers at 4 x 256 prompt tokens, 32 new (the near-tie rule against
   ``generate()``), at full depth ``export_layer`` of its forward at a
   dynamic batch through
   ``create_predictor`` (K4a 24 times a run, logits within TOL of the
   eager forward's) and a ``BatchScheduler`` over that predictor (16
   one-row requests from 4 threads, batches of at most 8 rows, each
   result within TOL of a one-row run); export s, archive MB, load s
   and ms a run printed;
31. tensor_api: the paddle API (``Tensor``, the flat op namespace,
   ``nn.functional``) on the card. (a) every row of ``ops.optable`` with
   ``set_device("gpu")``: each output against the row's numpy ``ref``
   within the row's atol / rtol and against the same row run on the CPU
   (``set_device("cpu")``) within them, dtypes equal, bool and integer
   outputs exact; every row with a real floating input and output also
   runs ``backward`` of ``sum(out * w)`` (w from seed 0) on both, the
   card's gradients within max(atol, 1e-5) / rtol of the CPU's (no row
   needs a wider bound on the card, cuSOLVER's decompositions included).
   (b) a llama_350m-width block
   (hidden 1024, 16 heads of 64, intermediate 2816, bf16, 8 x 1024
   tokens, weights from seed 0 held as ``Tensor``s that need gradients):
   ``rms_norm``, q / k / v ``pt.matmul``, ``reshape``, causal
   ``flash_attention``, the output projection and residual,
   ``rms_norm``, SwiGLU, the residual, the mean loss and
   ``loss.backward()`` (``api_block``), against the same block written
   in torch over the kernel wrappers (``direct_block``): loss and every
   gradient bitwise equal; the API block's launches, counters zeroed
   just before and read just after, K5a 2, K4a 1, K4b 1 (dq and dk + dv)
   and K5b 2 and no other kernel; both blocks' ms a step, and the API's
   cost a dispatched op (``api_cost_us``: ``pt.add`` on a one-element
   tensor less ``torch.add``, the least of five medians of 40
   alternating batches of 250), held within the parent tree's spread of
   the same statistic (``API_US_SPREAD``; the parent has no static
   recorder's hook in ``dispatch``); 10,000 calls of each in a row
   printed beside it (the earlier statistic). Given ``--parent``,
   the parent's ``pt.add`` (imported as ``ptt_parent``) is measured in the
   same process by both statistics, change and parent alternating;
32. nn_layers: the random ops and ``nn``'s layers on the card. (a) every
   random op, ``uniform_``, ``exponential_`` and every initializer under
   ``pt.seed(0)``, f32 and bf16, on the card (R2's bits, uniform, normal
   and truncated-normal fills) and on the CPU (their plain versions): bit
   for bit, Orthogonal's QR (cuSOLVER) within 1e-5; ``randn`` of 2**26
   elements: mean within 1e-3 of 0 and std of 1; the uniform and normal
   fills at 4096 x 4096 f32 timed beside their bounds and beside
   ``torch.rand`` / ``torch.randn`` (Philox: another function, a
   yardstick). (b) every layer class of ``layers_basic``, ``rnn`` and
   ``transformer`` at a small size, built on the card and on the CPU
   under one seed, forward and backward, within its row's tolerance
   (``NN_TOL``; the cuDNN and cuSOLVER rows named); ``RMSNorm``
   launches K5a 1 and K5b 1, ``MultiHeadAttention`` (head dims 64, 32
   and 96, no mask, eval) K4a 1. (c) Transformer-base (``nn.Transformer()``'s
   defaults, a shared 37,000-token embedding and output projection,
   dropout 0.1, ``attn_dropout=0``): one f32 step at 2 x 128 / 120
   tokens against the CPU (``TBASE_TOL``; each gradient at its own scale
   but the key projections' biases, 0 in exact arithmetic), K4a 12, K4b
   12 + 12 and R2's dropout twice a ``Dropout`` layer; 10 AdamW steps at
   64 x 128 / 120 under ``auto_cast`` bf16, the counts zeroed just before
   and read just after: 10 x those launches, no fill, a falling loss, ms
   a step, tokens/s and peak memory; the ms a step with paddle's default
   ``attn_dropout=0.1`` (the composition). (d) a 2-layer LSTM, input and
   hidden 1024: the card against the CPU at batch 2 x 128, and ms a
   forward and backward at 32 x 128. (e) the host's microseconds a call
   of ``Layer.__call__`` against ``torch.nn.Module.__call__`` on one
   small ``Linear``;
33. zoo_parity: ``bert_tiny``, ``dit_tiny`` and ``qwen_vl_tiny`` in f32
   (DiT's and the ViT's heads cut from 4 to 2: head dim 16, which K4
   takes), built on the CPU from one seed (DiT's zero-initialised adaLN and
   final projections redrawn) and copied to the card: one forward, loss
   and backward on each, values within 1e-5 of the CPU's and gradients
   within 1e-3 of each tensor's scale (floored at 1e-3 of the model's
   largest gradient), the launches counted (K4 where the model attends
   without a mask, K5 and K6 in the text tower); ``QwenVL.generate``'s
   greedy and seeded-sampled tokens equal to the CPU's; every tail op and
   layer of ``nn`` (48 rows and ``class_center_sample``) forward and input
   gradients within ``ZOO_TOL``; ``feature_alpha_dropout``'s mask the
   CPU's bit for bit (one R2 fill); beam search over a GRU cell, the
   CPU's ids;
34. zoo: at full width in bf16 from seed 0. BERT-base (``bert_base()``)
   pretraining at 32 x 512 (15% masked labels, NSP), AdamW(1e-4) under
   ``auto_cast`` bf16: 2 warm-up steps, 8 timed with the counters zeroed
   just before and read just after; ms a step, tokens/s, peak, a profile;
   gates: the loss falls, K4 = 0 (dropout 0.1: the reference's routing),
   R2's dropout twice each dropout a step, the fused AdamW step once;
   ``BertForSequenceClassification`` eval at 32 x 128 with padding: finite
   logits, no launch. DiT-S/4 (``dit_s_4()``) at batch 256 likewise: ms a
   step, images/s, peak; gates: the loss falls, K4a 12 and K4b 12 + 12 a
   step. Qwen-VL (``QwenVLConfig()``: ViT-L/14 at 224 into a Llama-2-7B-wide
   text tower, ~7.05 B parameters) on 4 images and 32-token prompts:
   forward + loss (K4a 24 + 32, K5a 65, K6 32, a finite loss), then
   ``generate`` of 32 tokens greedy and sampled (0.8, top_k 50, top_p
   0.95): time to first token, ms a token, peak (with the serve phase's
   7B when it ran); gates: 32 tokens a row, K4a 24 a call (the ViT), R2
   one fill a sampled token;
35. int8_infer: the serve phase's Llama-2-7B (full width and depth):
   one bf16 forward of 8 x 512 ids from seed 0, then
   ``to_int8_inference(model, inplace=True)`` and the same forward with
   the counters zeroed just before and read just after: 7 x layers + 1
   K8 launches, the forward's K4, K5 and K6 launches as in bf16 (K6's
   q + k once a layer), no other kernel, finite logits; top-1 agreement
   and the largest relative logit
   error against bf16, ms per forward and tokens/s for both, peak memory,
   a profile of one forward of each;
36. train: llama_350m in bf16 at full width and depth, AdamW(1e-4) with
   f32 moments, one fixed 8 x 1024 batch from seed 0: 2 warm-up steps,
   then 10 timed with the counters zeroed just before and read just
   after (K4: 10 x layers each, K5: 10 x (2 x layers + 1) each, K6's q +
   k launch 10 x 2 x layers, all on the vector route, no single-tensor
   K6; the fused AdamW step 10 times, one kernel each); the loss must
   fall and stay finite, gradients finite; step time, tokens/s, peak
   memory and a profile of one step (its launches, the optimizer's
   device time);
37. train_compose: the same model, weights, batch and optimizer with rope
   on the composition (``ops.rope._COMPOSITION_ONLY``, set for the phase
   and restored after it): 2 warm-up steps and 5 timed, the counters
   zeroed before the first and read after the last (no K6); the 7 losses
   equal to the train phase's first 7 bit for bit (K6 is the composition
   bit for bit, forward and backward); ms per step of both phases from
   this call, and a profile of one step;
38. train_amp: the slice's path. llama_350m at full width and depth
   from seed 0, ``amp.decorate(level="O2", dtype="bfloat16")`` (the rope
   tables stay f32), ``AdamW(multi_precision=True, weight_decay=0.01``
   off the norms, ``grad_clip=ClipGradByGlobalNorm(1.0))`` on the fused
   kernel, ``LinearWarmup(CosineAnnealingDecay(3e-4, T_max=100), 5
   steps from 0)`` stepped once a step; 12 steps under
   ``auto_cast(level="O2")`` on the fixed 8 x 1024 batch (the first by
   hand, to hold the clip scale against the plain global norm), the
   counters zeroed before and read after: the loss falls, all finite, each
   step's lr the scheduler's ``get_lr_at``, every clip scale <= 1,
   launches = steps x (K4; K5 on its f32 route; K6's q + k on the vector
   route; one optimizer step of 3 kernels); ms a step, tokens/s, peak
   memory and a profile of one step. Then f32 llama_350m under O1 with
   ``GradScaler(2**15, decr_every_n_nan_or_inf=1)``: 3 steps, an inf
   written into one gradient of the second: that step is skipped
   (parameters unchanged bit for bit, the optimizer not stepped) and the
   scale halves;
39. fit: the high-level loop, ``Model.fit`` under ``TrainSupervisor``.
   llama_350m in bf16 at full width and ``FIT_LAYERS`` (12) of its 24
   layers from seed 0 (each checkpoint save's time follows the depth),
   ``AdamW(1e-4, weight_decay=0.01)``, ``nn.CrossEntropyLoss()``, a
   ``TensorDataset`` of 96 rows of 1025 seeded ids (inputs the first
   1024, labels the last 1024), batch 8 (12 batches an epoch), 2 fork
   workers, a checkpoint at each run's end (and at B's preemption)
   keeping 1, in a temporary directory removed at the end. Run A: one uninterrupted epoch, the
   counters zeroed just before and read just after (12 x the train
   step's K4, K5 and K6 launches, the fused AdamW step 12 times, no
   other kernel), with ``TelemetryCallback`` and a registry on the
   supervisor (12 steps in the step histogram, 12 x 8 x 1024 tokens,
   its one checkpoint save, last good step 12); its ms per step (median
   of the steps that saved no checkpoint) beside the train phase's, tokens/s, peak memory, the
   loader's wait a step, seconds and GB/s of every checkpoint save, the
   guarded and the plain step each ended by the loss read, the key
   split, the batch's move and a profile of one guarded step. Run B:
   the same, preempted from a callback after step 5; run C: a fresh
   model and supervisor over B's directory resume it: B's losses then
   C's equal A's bit for bit, and C's final parameters A's. Run E:
   ``evaluate`` over 2 batches, forward launches only, a finite loss.
   Run F: ``Model.save`` and ``Model.load`` into another model, the
   parameters bit for bit. Run D: 3 batches, the loss NaN at step 2:
   skipped, every parameter and optimizer state unchanged bit for bit
   across it while the step count advances, the fused step launched 2
   times. All losses but the injected one finite; the loss falls.
40. static_jit: ``paddle.static`` and ``paddle.jit`` on the card, seed
   0, bf16. (a) ``static_stack``: ``static_block`` (``api_block``'s Llama
   block with keyword reshapes) 24 times at llama_350m's widths from
   ``static.data("x", [8, 1024, 1024], "bfloat16")``, each block's
   weights from ``static.create_parameter`` (drawn on the card before
   the build), ``AdamW(1e-4).minimize``; building launches nothing
   (shapes on the meta device); three ``Executor.run`` calls, each
   loss bitwise the same stack's eager step through the flat API
   (``eager_stack``) and falling, each run K5a 48, K4a 24, K4b 24 + 24,
   K5b 48 and the fused AdamW step once; then the ``for_test`` clone
   (K4a 24, K5a 48), ``save_inference_model`` / ``load_inference_model``
   and the archive's loss bitwise the Executor's fetch, its K4a 24 and
   K5a 48 through the custom ops. Build time, ms per run, peak memory,
   export, load and archive run times, the archive's MiB. (b)
   ``LlamaForCausalLM(llama_350m())`` at 8 x 1024: ``to_static``'s logits
   bitwise the eager forward's (K4a 24, K5a 49, K6 24 q + k);
   ``grad_and_loss``'s loss and 219 gradients bitwise eager autograd's
   (adding K4b 24 + 24, K5b 49, K6's backward 24); ``jit.save`` with
   ``InputSpec([-1, 1024], "int64")``, ``jit.load``, the archive at batch
   8 and 4 bitwise eager. ms a forward and a step, save and load
   seconds, the archive's MiB. (c) dy2static: ``to_static`` with a
   tensor-dependent ``if`` and a converted ``for`` loop (run and
   exported, ``while_loop``) on card tensors equal to the CPU; a layer
   calling the ``to_static`` function saved by ``jit.save`` holds a
   ``torch.cond`` and takes both branches as the eager layer does;
41. quant_parity: the quant phase's paths at llama_tiny / tiny widths in
   f32, on the card and on the CPU from the same weights and batches:
   ``QAT(QuantConfig(FakeQuanterWithAbsMaxObserver(0.9),
   FakeQuanterChannelWiseAbsMax()))`` and 3 ``train_step_fn`` + AdamW
   steps (losses and the 15 moving scales within ``QUANT_PARITY_TOL``,
   launches = 3 train steps'), ``convert`` and ``to_int8_inference`` of the
   CPU-trained weights on both (int8 codes and scales equal, K8 15 a
   forward, logits within 1e-3 of the largest); ``fused_multi_transformer``
   (2 layers, d 64) without a cache (K4a 2), with a static and a growing
   cache; ``fused_linear_cross_entropy`` of the hidden states;
42. quant: llama_350m in bf16 from seed 0 at the train phase's 8 x 1024.
   (b) ``model.loss`` against ``fused_linear_cross_entropy(model(ids,
   return_hidden=True)[:, :-1], lm_head.weight, ids[:, 1:],
   chunk_size=1024)``, forward and backward: the loss and ``lm_head``'s
   gradient within ``FUSED_CE_TOL``, the fused step's peak memory below
   the plain one's, ms of each. PTQ with ``AbsmaxObserver`` on the
   activations: 4 calibration batches of 2 x 512 timed, all 169 observers
   calibrated and frozen by ``convert``. (a) ``QAT`` of the same config
   swaps 169 Linears (24 x 7 and ``lm_head``); the logits are f32 (the
   reference's promotion); 2 warm-up and 10 timed AdamW(1e-4) steps, the
   counters zeroed just before and read just after: the train step's
   launches x 10, losses finite and falling; ms a step beside the train
   phase's, tokens/s, peak memory, a profile of one step. ``convert``,
   then ``to_int8_inference`` in place and a forward at 8 x 512: K8 169,
   logits within 5% of the largest of the converted QAT model's eval
   logits (the rule of tests/test_generation.py), ms a forward and a
   profile. (c) ``fused_multi_transformer`` at GPT-2 345M's widths (24
   layers, d 1024, 16 heads, FFN 4096, gelu, pre-LN), bf16 weights from a
   seed, 8 x 512: without a cache (K4a 24); a static-cache (``time_step``)
   prefill into ``[2, 8, 16, 544, 64]`` caches and 32 decode steps, and
   the growing cache's: static = growing within ``STATIC_CACHE_RTOL`` in
   f32 and in bf16 (each bf16 path also against the f32 run); ms a
   prefill and a decode step. (d) ``FusedTransformerEncoderLayer`` at the
   same widths, dropout 0.1, one bf16 training step: R2's dropout 8 times
   (4 forwards, 4 backwards), no K4 (attention dropout takes the
   composition).
43. moe_parity: ``mixtral_tiny`` in f32 on the card and on the CPU from
   the same weights and ids (``moe_parity_run``): each block's routing
   (the gate's top-2 experts of every token) equal but at near-ties of
   the CPU's gate probabilities (``MOE_TIE``); the dispatch masks and the
   logits (within ``MOE_PARITY_TOL``) equal at the tokens no flip
   reaches; the aux loss, every parameter's gradient and 3
   ``train_step_fn`` + AdamW steps' losses within ``MOE_PARITY_TOL``,
   which needs equal routing: a near-tie flip fails them
   (``moe_parity_compare``);
44. moe: Mixtral's training path at full width and depth,
   ``moe_350m_8e(moe_group_size=1024)`` (the JAX repo's MoE bench
   configuration: 12 layers, hidden 768, 8 SwiGLU experts of 2048, top 2,
   GShard grouped dispatch, the aux loss in the step) in bf16 from seed 0,
   batch 8 x 1024, AdamW(1e-4) with ``ClipGradForMOEByGlobalNorm(1.0)``:
   the batches from ``io.DataLoader(num_workers=2, use_native_ring=True)``
   over a token dataset repeating the 8 rows of seed 0 (the train phase's
   fixed batch), each equal to the queue transport's; 2
   warm-up steps by hand, then 10 ``train_step_fn`` steps, the counters
   zeroed just before and read just after: the launches equal 10 x the
   per-step counts (K4 12 + 12 + 12, K5 25 + 25, K6 q + k 24, one fused
   step of ``kernels_per_step`` kernels), no K1-K3, K7, K8; losses finite
   and falling; ms a step, tokens/s, peak memory; one more step traced by
   the port's ``profiler.Profiler`` inside a ``RecordEvent``: its Chrome
   trace names K4, K5, K6 and the fused step's kernels and the range, and
   its kernels' time gives the device's busy share of an untraced step
   (and of the traced step's wall, which the profiler lengthens); the dispatch and gather products of a
   step timed apart (``cuda_ms``) for their share;
45. host: the host-side framework on the card: two ``device.cuda.Stream``s
   and timing ``Event``s, a K5a launch on a side stream under
   ``stream_guard`` bitwise the default stream's; ``device.memory_stats()``
   ``peak_bytes_in_use`` = ``torch.cuda.max_memory_allocated()``;
   ``device.synchronize``; ``set_flags({"FLAGS_check_nan_inf": 1})`` makes
   a NaN on the card raise; a ``runtime.TCPStore`` set / get / add on
   localhost; a ``utils.cpp_extension`` elementwise op on a card tensor,
   values and gradient; ``utils.run_check()`` on the card;
46. vision_parity: ``vision.models.resnet18(num_classes=10)`` and
   ``mobilenet_v2(scale=0.25, num_classes=10)`` from seed 0, built on the
   CPU and copied to the card, f32 with TF32 off (the flags printed): one
   eval-mode forward, cross-entropy loss and backward on [2, 3, 64, 64],
   logits, loss and every gradient within ``VISION_TOL`` (the CPU's run
   takes the card's side of each ReLU kink: at most ``VISION_MAX_FLIPS``
   inputs a model, each within ``VISION_KINK_TOL`` of its layer's largest
   |input| from the kink), no port kernel;
   MobileNetV2's ``Dropout(0.2)`` on [64, 1280] under one seed: output
   and input gradient bit for bit the CPU's (R2's dropout forward 1,
   backward 1); ``nms`` of 500 boxes with tied scores, the CPU's indices;
   ``roi_align`` (adaptive grid and 2 x 2), ``roi_pool``, ``psroi_pool``,
   ``deform_conv2d`` (two deformable groups, a mask) and ``yolo_loss``,
   values and input gradients within ``VISION_TOL``; ``decode_jpeg`` of a
   JPEG written here, read to the card, the CPU's bytes; ``fft.rfftn`` /
   ``ihfftn`` and ``signal.stft`` / ``istft`` within ``VISION_TOL``;
47. vision: at full width in f32 (TF32 off) on one fixed 64 x 3 x 224 x
   224 batch from seed 0, 1000 classes. ``resnet50()`` (25.6M parameters)
   under ``Momentum(0.025, 0.9)``, weight decay 1e-4 (PaddleClas's
   ImageNet ResNet50 configuration, its rate 0.1 for 256 images scaled to
   one card's 64), and ``mobilenet_v2()`` under
   ``AdamW(1e-3)``: 2 warm-up steps, 10 timed with the counters zeroed just
   before and read just after, 1 traced by the port's profiler inside a
   ``RecordEvent``; ms a step, images/s, peak memory, the traced step's
   kernels over an untraced step's time (the busy share), its launches and
   top kernels; gates: losses finite and falling, ResNet-50 no port kernel,
   MobileNetV2 the fused AdamW step once a step and R2's dropout twice a
   step (forward and backward of its one ``Dropout``), nothing else.
   ResNet-50 at PaddleClas's own rate 0.1 (``vision_rate_witness``): 6
   steps of the port, each beside one ``torch.optim.SGD`` step over
   torch's ``batch_norm`` from the same weights and velocity, within
   ``WITNESS_TOL``; the port and SGD run free both rise there. Then
   the data path: 128 seeded 256 x 256 JPEGs in 4 class folders,
   ``DatasetFolder`` with ``RandomResizedCrop(224)``,
   ``RandomHorizontalFlip()``, ``ToTensor()``, ``Normalize`` through
   ``DataLoader(num_workers=4)``: one epoch alone (the loader's images/s)
   and ``hapi.Model(mobilenet_v2(num_classes=4)).fit`` over it (2 steps,
   finite losses, Opt 2 and R2's dropout 4). Then the detection ops at a
   detector's widths: ``roi_align`` of 2 x 512 boxes on [2, 256, 50, 84]
   at 7 x 7 (stride 16) forward and backward, and ``nms`` of 2000 boxes:
   ms and the card's kernel count of each (no port kernel).

Each phase ends with a ``phase <name> <seconds>`` line. The last two
lines of standard output are the per-kernel JSON record
and ``{"ok": true, "device": {...}}``. Without a CUDA card, or without
the ``paddle_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "opt",
          "rng", "parity", "dense_parity", "preempt_parity", "train_parity",
          "int8_parity", "serve", "dense", "preempt", "telemetry",
          "fleet_parity", "fleet", "wire_parity", "wire", "family_parity",
          "families", "decode_parity", "decoding", "deploy", "tensor_api",
          "nn_layers", "zoo_parity", "zoo", "int8_infer",
          "train", "train_compose", "train_amp", "fit", "static_jit",
          "quant_parity", "quant", "moe_parity", "moe", "host",
          "vision_parity", "vision")

# NVIDIA data sheets, dense rates: (bytes/s, bf16 FLOP/s, fp32 FLOP/s
# outside the tensor cores, int8 tensor-core operations/s). The SXM part
# is the default.
CARD_PEAKS = {
    "H100 SXM": (3.35e12, 989e12, 67e12, 1979e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
    "H100 NVL": (3.9e12, 835e12, 60e12, 1670e12),
}

# bf16 holds 8 significant bits: the kernels accumulate in f32 and round
# once at the output, so against the plain version evaluated in f32 on
# the same bf16 inputs the error is the output's rounding, <= 2^-8 of
# |out| (outputs here are below ~3), with room for summation order.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# An absolute bound sized for outputs of ~3 is loose for long-context
# rows, whose outputs average over ~1000 keys and shrink to ~0.05–0.1:
# a kernel that dropped some of their keys could pass it. So each output
# vector (one row under one query head) is also held to its own scale:
# its largest error over the head dims over its largest |value|. The
# kernels' own share is ~2^-8 in bf16 (output rounding, and K3's bf16
# probabilities in P V) and ~1e-5 in f32.
VEC_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The Gumbel noise of R1 and R2 against the plain version on the card, in
# f32 ulps of max(|g|, 1): both take each log in f64 and round it to f32
# (core.prng.log_rn), so they should agree bit for bit; the plain version
# is held to jax.random by the same two ulps on the CPU
# (tests/test_torch_random.py).
RNG_ULPS = 2


def log(*a):
    print(*a, flush=True)


def agreement(pairs, dname, floor=0.0):
    """Largest absolute error and largest vector-relative error (see
    VEC_RTOL) of kernel outputs against their plain versions, over
    (out, ref) pairs of rows [..., hd] the caller reads; and whether
    both are within tolerance. A vector whose plain value is all zero
    must come out all zero — unless ``floor`` > 0: then each vector's
    scale is at least ``floor`` times the largest |value| of its tensor.
    Gradients need that: a vector that is zero in exact arithmetic (dq
    of causal row 0, which sees one key) is rounding noise on both
    sides."""
    abs_err = rel_err = 0.0
    for out, ref in pairs:
        d = (out.float() - ref).abs().amax(-1)
        abs_err = max(abs_err, d.max().item())
        scale = ref.abs().amax(-1).clamp_min(
            max(1e-30, floor * ref.abs().max().item()))
        rel_err = max(rel_err, (d / scale).max().item())
    return abs_err, rel_err, (abs_err <= TOL[dname]
                              and rel_err <= VEC_RTOL[dname])


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def peaks(name):
    key = "H100 PCIe" if "PCIe" in name else \
        "H100 NVL" if "NVL" in name else "H100 SXM"
    return key, CARD_PEAKS[key]


_SPIN = {}     # cycles of torch.cuda._sleep per millisecond, measured once


def spin_cycles_per_ms(torch):
    if "per_ms" not in _SPIN:
        torch.cuda._sleep(100_000)                   # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = 2_000_000 / start.elapsed_time(end)
    return _SPIN["per_ms"]


def cuda_ms(fn, torch, iters=20, warmup=3, flush=None):
    """Median milliseconds of the card's work in one call of ``fn``, the
    L2 cache flushed before every timed call (the main path finds it
    cold). Only the card's time counts: before each timed call the
    stream gets a spin kernel (``torch.cuda._sleep``) that outlasts the
    host side of ``fn`` (contract checks, allocation, the ctypes call,
    PyTorch's dispatch), so the start event is reached after ``fn`` has
    queued all its work. A sample whose start event had already been
    reached when ``fn`` returned on the host (the spin was too short) is
    dropped and the spin doubled. Kernels, their plain versions and the
    library yardsticks are all timed so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int(max(0.05, 3 * host_ms) * spin_cycles_per_ms(torch))
    times, dropped = [], 0
    while len(times) < iters:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end))
            continue
        dropped += 1
        spin *= 2
        if dropped > 12:
            raise SystemExit("cuda_ms: the host side of a timed call "
                             "outlasted every spin")
    times.sort()
    return times[len(times) // 2]


def event_ms(fn, torch, iters=10, warmup=2, flush=None):
    """Median milliseconds between CUDA events recorded just before and
    just after ``fn``, the L2 flushed first: the card's time plus the
    gaps its launches leave. For calls of more launches than the card's
    launch queue holds (the per-leaf optimizer chain: ~4000), whose host
    side ``cuda_ms``'s spin cannot cover: the host blocks on the full
    queue while the spin runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# Thread instructions a clock an SM by the pipe they issue to (NVIDIA H100
# Tensor Core GPU Architecture white paper: a Hopper SM has 64 INT32
# lanes, 128 FP32 lanes, 64 FP64 lanes and four schedulers that issue one
# warp instruction a clock each; the CUDA C++ Programming Guide's
# throughput table for compute capability 9.0: 32-bit integer multiply-add,
# IMAD, 64 a clock an SM, on the FMA pipe). card_rates multiplies them by
# the card's SMs and its maximum SM clock; sass_class says which opcode
# counts where.
LANES = {"alu": 64, "imad": 64, "fma": 128, "fp64": 64, "int": 128,
         "issue": 128}
RATES = {}          # instructions a second by pipe, set by card_rates


def card_rates(torch):
    """{pipe: instructions a second} of card 0: SMs (the device
    properties) x lanes an SM (LANES) x the maximum SM clock
    (nvidia-smi's clocks.max.sm); also "sms" and "clock_mhz"."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    RATES.update({k: sms * n * mhz * 1e6 for k, n in LANES.items()},
                 sms=sms, clock_mhz=mhz)
    return RATES


INSTR = ("alu", "imad", "flex", "fp32", "fp64", "uniform", "other")


def instr_terms(c):
    """{term: ms} of instruction counts ``c`` ({class: instructions},
    INSTR) over the card's rates: "alu" the integer ALU pipe; "imad" IMAD
    and VIADD on the FMA pipe at their own rate; "fma" those and the FP32
    instructions on its 128 lanes; "fp64"; "int" the integer work the ALU
    and IMAD can share ("flex": adds either takes) over both; "issue"
    every instruction over the schedulers' 128 lanes a clock."""
    g = lambda k: c.get(k, 0)                                  # noqa: E731
    n = {"alu": g("alu"), "imad": g("imad"), "fma": g("imad") + g("fp32"),
         "fp64": g("fp64"), "int": g("alu") + g("imad") + g("flex"),
         "issue": sum(g(k) for k in INSTR)}
    return {k: v / RATES[k] * 1e3 for k, v in n.items() if v}


def bound(nbytes, flops, peak, ops_peak=None, instr=None, term=False):
    """(bound_ms, bound_by): the largest of bytes over the memory rate,
    operations over ``ops_peak`` (by default the bf16 tensor-core peak;
    the f32 or int8 entry of ``peak`` for those types), and instruction
    counts ``instr`` over their pipes' rates (instr_terms). ``bound_by`` is
    "bytes" or "operations"; ``term=True`` adds the winning term's name
    (bytes, operations or one of instr_terms')."""
    bw = peak[0]
    ops_peak = peak[1] if ops_peak is None else ops_peak
    terms = {"bytes": nbytes / bw * 1e3, "operations": flops / ops_peak * 1e3}
    terms.update(instr_terms(instr or {}))
    name = max(terms, key=terms.get)
    out = (terms[name], "bytes" if name == "bytes" else "operations")
    return out + (name,) if term else out


def paged_case(torch, S, nh, kvh, hd, pg, maxp, dtype, gen):
    """Pool, block tables (distinct random pages per slot) and q."""
    P = S * maxp + 1
    dev = "cuda"
    kp = torch.randn((P, pg, kvh, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, pg, kvh, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:S * maxp].reshape(S, maxp).to(torch.int32).contiguous()
    return kp, vp, bt


def gathered(torch, kp, vp, bt, rep):
    """K/V gathered through the block table into the contiguous
    [S, heads, T, hd] frame SDPA takes (heads repeated for GQA)."""
    S, maxp = bt.shape
    _, pg, kvh, hd = kp.shape
    k = kp[bt.long()].reshape(S, maxp * pg, kvh, hd)
    v = vp[bt.long()].reshape(S, maxp * pg, kvh, hd)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    return k, v


K1_KERNELS = ("paged_decode_split_kernel", "split_merge_kernel")
K3_KERNELS = ("fused_decode_split_kernel", "split_merge_kernel",
              "fused_prefill_mma_kernel")


def phase_k1(torch, peak, flush, record):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    log_ptxas("k1", "paged_attention", K1_KERNELS)
    S, pg, maxp, hd = 8, 16, 128, 128
    T = maxp * pg
    # empty slot, 1 token, page-unaligned, full table, parked (T + 1),
    # and three mid-length slots
    lens = [0, 1, 17, T, T + 1, 700, 1500, 333]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for nh, kvh, tag in ((32, 32, "7b"), (64, 8, "70b-gqa")):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp, dtype,
                                    gen)
            q = torch.randn((S, nh, hd), generator=gen,
                            device="cuda").to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            scale = hd ** -0.5
            out = pa.paged_attention(q, kp, vp, bt, lengths, scale)
            again = pa.paged_attention(q, kp, vp, bt, lengths, scale)
            torch.cuda.synchronize()
            repeat = torch.equal(out, again)
            ref = pa._ref_paged_attention(q.float(), kp.float(), vp.float(),
                                          bt, lengths, scale)
            err, rel, close = agreement([(out, ref)], dname)
            del ref, again
            # poison: every page that no slot's first ceil(min(len, T) /
            # pg) table entries name -> NaN; no output may move by a bit
            seen = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
            for s, n in enumerate(lens):
                if min(n, T) > 0:
                    seen[bt[s, :-(-min(n, T) // pg)].long()] = True
            kpn, vpn = kp.clone(), vp.clone()
            kpn[~seen] = float("nan")
            vpn[~seen] = float("nan")
            out2 = pa.paged_attention(q, kpn, vpn, bt, lengths, scale)
            torch.cuda.synchronize()
            same = torch.equal(out, out2)
            del kpn, vpn, out2
            ok = close and repeat and same and torch.isfinite(out).all().item()
            log(f"k1 {tag} {dname}: max_abs_err {err:.3e} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}), second launch bitwise equal "
                f"{repeat}, unnamed pages NaN-poisoned: outputs bitwise "
                f"equal {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k1 {tag} {dname} disagrees with its "
                                 f"plain version")
            if dtype == torch.bfloat16:
                k1_time(torch, pa, tag, q, kp, vp, bt, lengths, lens, scale,
                        peak, flush, record, err)
            del q, kp, vp, bt, out
    torch.cuda.empty_cache()


def attn_costs(q, kp, bt):
    """The port's price model of one layer's paged attention at these
    tensors' shapes (``models.costs.AttentionCosts``, what the server's
    cost catalog charges): the bounds of K1, K2 and K3."""
    from paddle_tpu_torch.models.costs import AttentionCosts
    _, pg, kvh, hd = kp.shape
    return AttentionCosts(q.shape[-2], kvh, hd, pg, bt.shape[1],
                          q.element_size())


def k1_time(torch, pa, tag, q, kp, vp, bt, lengths, lens, scale, peak,
            flush, record, err):
    """K1 in bf16 beside its plain version, one SDPA call over the
    gathered masked frame (a yardstick the port never calls) and its
    bound; the 7B case (the main path's) goes into the record."""
    import torch.nn.functional as F
    nh = q.shape[1]
    pg, kvh = kp.shape[1:3]
    T = bt.shape[1] * pg
    ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, lengths, scale),
                 torch, flush=flush)
    plain_ms = cuda_ms(lambda: pa._ref_paged_attention(
        q, kp, vp, bt, lengths, scale), torch, iters=5, flush=flush)
    k, v = gathered(torch, kp, vp, bt, nh // kvh)
    mask = (torch.arange(T, device="cuda")[None]
            < lengths[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale), torch, flush=flush)
    del k, v, mask
    flops, nbytes = attn_costs(q, kp, bt).k1(lens)
    bound_ms, by = bound(nbytes, flops, peak)
    split_ms, merge_ms = (profiled_ms(
        torch, lambda: pa.paged_attention(q, kp, vp, bt, lengths, scale),
        names, flush) for names in (K1_KERNELS[:1], K1_KERNELS[1:]))
    if tag == "7b":
        record["paged_attention"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by)
    log(f"k1 {tag} bf16 timing: kernel {ms:.4f} ms (profiler: splits "
        f"{fmt_ms(split_ms)}, merge {fmt_ms(merge_ms)}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), "
        f"bound {bound_ms:.4f} ms ({by}; {nbytes} bytes, {flops} flops)")


def fmt_ms(x):
    return "no device time (not measured)" if x is None else f"{x:.4f} ms"


def k2_cases(T):
    """(tag, C, nh, kvh, hd, [(t0, take) per slot], dtypes, timed) of
    the cases K2 is held at, S = 8 slots over 128 pages of 16: the serve
    phase's admission tick at Llama-2-7B's heads (the main path) and at
    Llama-2-70B's GQA layout, both dtypes, each timed in bf16 (cold and
    prefix-offset chunks, page-aligned and mid-page, an idle slot at the
    scheduler's t0 = T sentinel, chunks ending mid-page); then bf16 edge
    cases at full widths, each with a slot whose frontier ends at the
    table's last column: C = 100 (a row tile straddles C), 32 query heads
    over 8 kv heads (rep 4: 16 rows x 4 heads a tile), llama_350m's 16
    heads of 64 and llama_tiny's 4 heads of 16 over 2."""
    bf, f32 = ("bfloat16",), ("bfloat16", "float32")
    admit = [(0, 512), (256, 512), (1000, 300), (T, 0), (37, 512),
             (512, 200), (1200, 512), (1536, 500)]
    to_end = admit[:-1] + [(T - 512, 512)]
    c100 = [(0, 100), (T - 100, 100), (1000, 37), (T, 0), (5, 100),
            (16, 64), (700, 99), (1900, 65)]
    return (("7b", 512, 32, 32, 128, admit, f32, True),
            ("70b-gqa", 512, 64, 8, 128, admit, f32, True),
            ("c100", 100, 32, 32, 128, c100, bf, False),
            ("rep4", 512, 32, 8, 128, to_end, bf, False),
            ("hd64", 512, 16, 16, 64, to_end, bf, False),
            ("hd16", 512, 4, 2, 16, to_end, bf, False))


def phase_k2(torch, peak, flush, record):
    from paddle_tpu_torch.ops.kernels import ragged_prefill as rp
    log_ptxas("k2", "ragged_prefill", ("ragged_prefill_mma_kernel",))
    S, pg, maxp = 8, 16, 128
    T = maxp * pg
    gen = torch.Generator(device="cuda").manual_seed(2)
    for tag, C, nh, kvh, hd, slots, dnames, timed in k2_cases(T):
        t0s = [t for t, _ in slots]
        takes = [n for _, n in slots]
        lasts = [t + n - 1 if n else -1 for t, n in slots]
        t0 = torch.tensor(t0s, dtype=torch.int32, device="cuda")
        last = torch.tensor(lasts, dtype=torch.int32, device="cuda")
        for dname in dnames:
            dtype = getattr(torch, dname)
            kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp, dtype,
                                    gen)
            q = torch.randn((S, C, nh, hd), generator=gen,
                            device="cuda").to(dtype)
            scale = hd ** -0.5
            out = rp.ragged_prefill_attention(q, kp, vp, bt, t0, last, scale)
            torch.cuda.synchronize()
            ref = rp._ref_ragged_prefill(q.float(), kp.float(), vp.float(),
                                         bt, t0, last, scale)
            err, rel, close = agreement(     # live rows only
                [(out[s, :n], ref[s, :n]) for s, n in enumerate(takes)
                 if n], dname)
            del ref
            idle_zero = all(out[s].abs().max().item() == 0.0
                            for s, n in enumerate(takes) if not n)
            # poison: every page past each slot's frontier (its last
            # position), every unused column's page and every page of an
            # idle slot -> NaN; the live rows must not move by a bit
            seen = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
            for s, x in enumerate(lasts):
                if x >= 0:
                    seen[bt[s, :x // pg + 1].long()] = True
            kpn, vpn = kp.clone(), vp.clone()
            kpn[~seen] = float("nan")
            vpn[~seen] = float("nan")
            out2 = rp.ragged_prefill_attention(q, kpn, vpn, bt, t0, last,
                                               scale)
            torch.cuda.synchronize()
            same = all(torch.equal(out[s, :n], out2[s, :n])
                       for s, n in enumerate(takes) if n)
            del kpn, vpn, out2
            ok = close and idle_zero and same \
                and torch.isfinite(out).all().item()
            log(f"k2 {tag} {dname}: C={C}, {nh} heads over {kvh} kv heads "
                f"of {hd}, max_abs_err {err:.3e} (tol {TOL[dname]:.0e}), "
                f"max vector-relative error {rel:.3e} (tol "
                f"{VEC_RTOL[dname]:.0e}), idle slot zero {idle_zero}, "
                f"pages past each frontier NaN-poisoned: live rows bitwise "
                f"equal {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k2 {tag} {dname} disagrees with its "
                                 f"plain version")
            if timed and dname == "bfloat16":
                k2_time(torch, rp, tag, q, kp, vp, bt, t0, last, slots,
                        scale, peak, flush, record, err)
            del q, kp, vp, bt, out
    torch.cuda.empty_cache()


def k2_time(torch, rp, tag, q, kp, vp, bt, t0, last, slots, scale, peak,
            flush, record, err):
    """K2 at the main path's shape beside its plain version, one SDPA call
    over the gathered masked frame (a yardstick the port never calls) and
    its bound; the 7B case goes into the record."""
    import torch.nn.functional as F
    C, nh = q.shape[1:3]
    pg, kvh = kp.shape[1:3]
    T = bt.shape[1] * pg
    ms = cuda_ms(lambda: rp.ragged_prefill_attention(
        q, kp, vp, bt, t0, last, scale), torch, flush=flush)
    plain_ms = cuda_ms(lambda: rp._ref_ragged_prefill(
        q, kp, vp, bt, t0, last, scale), torch, iters=5, flush=flush)
    k, v = gathered(torch, kp, vp, bt, nh // kvh)
    pos = torch.arange(T, device="cuda")
    row = t0.long()[:, None] + torch.arange(C, device="cuda")[None]
    mask = (pos[None, None] <= row[:, :, None])[:, None]
    qq = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale), torch, flush=flush)
    del k, v, mask
    flops, nbytes = attn_costs(q, kp, bt).k2(slots, C)
    bound_ms, by = bound(nbytes, flops, peak)
    if tag == "7b":
        record["ragged_prefill"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by)
    log(f"k2 {tag} bf16 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
        f"{nbytes} bytes, {flops} flops)")


def k3_ticks(T):
    """(name, C, [(t0, take, dec) per slot]) of the two ticks K3 is held
    at: an admission tick (cold and prefix-offset chunks, two decode
    rows, an idle slot at the scheduler's t0 = T sentinel, chunks ending
    mid-page) and a decode-only tick at K1's lengths (clamped to
    [1, T]: a decode row has at least itself to attend to)."""
    admit = [(0, 512, 0), (256, 512, 0), (1000, 300, 0), (T, 0, 0),
             (700, 1, 1), (512, 200, 0), (1500, 1, 1), (1536, 500, 0)]
    decode = [(max(1, min(n, T)) - 1, 1, 1)
              for n in (0, 1, 17, T, T + 1, 700, 1500, 333)]
    return (("admit", 512, admit), ("decode", 1, decode))


def phase_k3(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_tick as ft
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    log_ptxas("k3", "fused_tick", K3_KERNELS)
    S, pg, maxp, hd = 8, 16, 128, 128
    T = maxp * pg
    gen = torch.Generator(device="cuda").manual_seed(3)
    for tick, C, slots in k3_ticks(T):
        t0_l = [t for t, _, _ in slots]
        last_l = [t + n - 1 if n else -1 for t, n, _ in slots]
        dec_l = [d for _, _, d in slots]
        rows = [1 if d else n for _, n, d in slots]    # live rows compared
        live_pages = max(x // pg + 1 for x in last_l if x >= 0)
        W = min(maxp, 1 << (live_pages - 1).bit_length())
        ss_np, sp_np, n_live = ft.build_schedule(last_l, pg, n_slots=S)
        dev = "cuda"
        t0 = torch.tensor(t0_l, dtype=torch.int32, device=dev)
        last = torch.tensor(last_l, dtype=torch.int32, device=dev)
        dec = torch.tensor(dec_l, dtype=torch.int32, device=dev)
        ss = torch.from_numpy(ss_np).to(dev)
        sp = torch.from_numpy(sp_np).to(dev)
        for nh, kvh, tag in ((32, 32, "7b"), (64, 8, "70b-gqa")):
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp,
                                        dtype, gen)
                bt_live = bt[:, :W].contiguous()
                q = torch.randn((S, C, nh, hd), generator=gen,
                                device=dev).to(dtype)
                scale = hd ** -0.5
                args = (bt_live, t0, last, dec, ss, sp, scale)
                out = ft.fused_tick_attention(q, kp, vp, *args)
                again = ft.fused_tick_attention(q, kp, vp, *args)
                torch.cuda.synchronize()
                repeat = torch.equal(out, again)
                del again
                ref = ft._ref_fused_tick(q.float(), kp.float(), vp.float(),
                                         bt_live, t0, last, dec, scale)
                err, rel, close = agreement(
                    [(out[s, :n], ref[s, :n]) for s, n in enumerate(rows)
                     if n], dname)
                del ref
                idle_zero = all(out[s].abs().max().item() == 0.0
                                for s, n in enumerate(rows) if not n)
                # poison: every page the schedule does not list -> NaN
                listed = torch.zeros(kp.shape[0], dtype=torch.bool,
                                     device=dev)
                live = ss < S
                listed[bt_live[ss[live].long(), sp[live].long()].long()] = \
                    True
                kpn, vpn = kp.clone(), vp.clone()
                kpn[~listed] = float("nan")
                vpn[~listed] = float("nan")
                out2 = ft.fused_tick_attention(q, kpn, vpn, *args)
                torch.cuda.synchronize()
                same = all(torch.equal(out[s, :n], out2[s, :n])
                           for s, n in enumerate(rows) if n)
                del kpn, vpn, out2
                # the price model's page count is the schedule's
                priced = attn_costs(q, kp, bt).k3_pages(slots) == n_live
                ok = close and idle_zero and same and repeat and priced \
                    and torch.isfinite(out).all().item()
                log(f"k3 {tick} {tag} {dname}: C={C} W={W} G={len(ss_np)} "
                    f"({n_live} live pages, priced {priced}), max_abs_err "
                    f"{err:.3e} (tol "
                    f"{TOL[dname]:.0e}), max vector-relative error "
                    f"{rel:.3e} (tol {VEC_RTOL[dname]:.0e}), idle slot "
                    f"zero {idle_zero}, second launch bitwise equal "
                    f"{repeat}, unlisted pages NaN-poisoned: live rows "
                    f"bitwise equal {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"k3 {tick} {tag} {dname} disagrees "
                                     f"with its plain version")
                if dtype == torch.bfloat16:
                    k3_time(torch, F, ft, pa, tick, tag, q, kp, vp, bt,
                            args, slots, peak, flush, record, err)
                del q, kp, vp, bt, bt_live, out
    torch.cuda.empty_cache()


def k3_time(torch, F, ft, pa, tick, tag, q, kp, vp, bt, args, slots,
            peak, flush, record, err):
    """K3 in bf16 beside its plain version, one SDPA call over the
    gathered masked frame (a yardstick the port never calls) and its
    bound; on the decode-only tick, K1 at the same lengths too. The 7B
    ticks (the main path's) go into the record: the admission tick's
    as the kernel's numbers, the decode-only tick's beside them."""
    bt_live, t0, last, dec, _, _, scale = args
    C, nh = q.shape[1:3]
    kvh = kp.shape[2]
    ms = cuda_ms(lambda: ft.fused_tick_attention(q, kp, vp, *args), torch,
                 flush=flush)
    plain_ms = cuda_ms(lambda: ft._ref_fused_tick(
        q, kp, vp, bt_live, t0, last, dec, scale), torch, iters=5,
        flush=flush)
    k, v = gathered(torch, kp, vp, bt_live, nh // kvh)
    Tl = k.shape[2]
    pos = torch.arange(Tl, device="cuda")
    row = t0.long()[:, None] + torch.arange(C, device="cuda")[None]
    mask = (pos[None, None] <= row[:, :, None])[:, None]
    qq = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale), torch, flush=flush)
    del k, v, mask
    # q: the live rows only (rows past a take, and rows 1.. of a decode
    # slot, need not be read); out: every row, as the contract writes
    # them (finite values past a take, zeros for an idle slot); K/V: the
    # scheduled pages; int32: their block-table and schedule entries, t0
    # and last
    flops, nbytes = attn_costs(q, kp, bt).k3(slots, C)
    bound_ms, by = bound(nbytes, flops, peak)
    names = K3_KERNELS[:2] if tick == "decode" else K3_KERNELS[2:]
    seen = []
    for n in names:
        x = profiled_ms(torch, lambda: ft.fused_tick_attention(
            q, kp, vp, *args), (n,), flush)
        seen.append(f"{n} {fmt_ms(x)}")
    seen = ", ".join(seen)
    extra = ""
    if tick == "admit" and tag == "7b":
        record["fused_tick"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by)
    elif tag == "7b":
        record["fused_tick"].update(
            decode_tick_ms=ms, decode_tick_library_ms=lib_ms,
            decode_tick_bound_ms=bound_ms)
    if tick == "decode":
        lengths = (t0 + 1).to(torch.int32)
        qd = q[:, 0].contiguous()
        k1_ms = cuda_ms(lambda: pa.paged_attention(qd, kp, vp, bt, lengths,
                                                   scale), torch, flush=flush)
        extra = f", K1 at the same lengths {k1_ms:.4f} ms"
    log(f"k3 {tick} {tag} bf16 timing: kernel {ms:.4f} ms (profiler: "
        f"{seen}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), "
        f"bound {bound_ms:.4f} ms ({by}; {nbytes} bytes, {flops} "
        f"flops){extra}")


# (tag, B, S_q, S_k, heads, head_dim, causal, types): llama_350m's
# training shape (the main path), Llama-2-7B's, a non-causal case and a
# tail tile (S = 1000), in both types; then bf16 cases at the edges of
# the kernels' 64-row tiles: S = 100 (one full tile and a tail), S_q !=
# S_k non-causal at head_dim 128 (key tiles past the row tiles, tails on
# both axes) and causal (the top-left diagonal at unequal lengths), and
# llama_tiny's head_dim 16 (one k-step)
BOTH, BF16 = ("bfloat16", "float32"), ("bfloat16",)
K4_CASES = (("350m", 8, 1024, 1024, 16, 64, True, BOTH),
            ("7b", 1, 4096, 4096, 32, 128, True, BOTH),
            ("noncausal", 4, 512, 512, 16, 64, False, BOTH),
            ("tail", 2, 1000, 1000, 8, 128, True, BOTH),
            ("s100", 4, 100, 100, 16, 64, True, BF16),
            ("rect", 2, 300, 1000, 16, 128, False, BF16),
            ("rect-causal", 2, 1000, 300, 8, 64, True, BF16),
            ("hd16", 4, 1024, 1024, 4, 16, True, BF16),
            ("hd32", 8, 1024, 1024, 8, 32, True, BOTH),
            ("hd96", 8, 1024, 1024, 8, 96, True, BOTH),
            ("hd96-rect", 2, 300, 1000, 8, 96, False, BF16),
            # the zoo's non-causal attention at head dim 64: DiT-S/4's
            # (batch 256, 64 tokens, 6 heads) and ViT-L/14's at 224 (4
            # images, 256 tokens, 16 heads)
            ("dit_s_4", 256, 64, 64, 6, 64, False, BF16),
            ("vit_l_14", 4, 256, 256, 16, 64, False, BF16),
            # moe_350m_8e's training step: 12 heads of 64
            ("moe", 8, 1024, 1024, 12, 64, True, BF16))
# the K4 cases timed (bf16), each with its bound and SDPA's time
K4_TIMED = ("350m", "7b", "hd32", "hd96", "dit_s_4", "vit_l_14")
K4_KERNELS = ("fwd_mma_kernel", "dq_mma_kernel", "dkv_mma_kernel")


def template_args(mangled):
    """The template arguments at the head of an Itanium-mangled list
    (``I...E`` without its ``I``), as text: ``13__nv_bfloat16Li4EE`` ->
    ``__nv_bfloat16,4``; ``fLb1EE`` -> ``f,1``; ``13__nv_bfloat16S1_Lb0E``
    -> ``__nv_bfloat16,__nv_bfloat16,0`` (a substitution repeats the type
    named before it)."""
    import re
    args, named = [], []
    while mangled and mangled[0] != "E":
        m = re.match(r"S\d*_", mangled)                 # a substitution
        if m is not None:
            # our kernels name one type at most: the one named before
            args.append(named[-1] if named else m.group(0))
            mangled = mangled[m.end():]
            continue
        m = re.match(r"L\w(-?\d+)E", mangled)          # a value
        if m is None:
            m = re.match(r"(\d+)", mangled)             # a named type
            if m is not None:
                n = int(m.group(1))
                name = mangled[m.end():m.end() + n]
                args.append(name)
                named.append(name)
                mangled = mangled[m.end() + n:]
                continue
            args.append(mangled[0])                      # a builtin type
            mangled = mangled[1:]
            continue
        args.append(m.group(1))
        mangled = mangled[m.end():]
    return ",".join(args)


def ptxas_report(stem, names):
    """{(kernel, template arguments): (registers, spill stores, spill
    loads)} from ptxas's report of ``csrc/<stem>.cu`` in this process's
    build, for the kernels named in ``names``."""
    import re
    from paddle_tpu_torch.ops.kernels import _build
    info = _build.build_log().get(stem)
    if info is None:
        return {}
    out, cur = {}, None
    for line in info["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = None
            for n in names:
                t = re.search(r"\d" + n + r"(I?)", m.group(1))
                if t:
                    rest = m.group(1)[t.end():]
                    cur = (n, template_args(rest) if t.group(1) else "")
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, [None, 0, 0])[1:] = [int(m.group(1)),
                                                    int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, [None, 0, 0])[0] = int(m.group(1))
    return out


def log_ptxas(phase, stem, names):
    """Log ptxas's registers and spills of the kernels ``names`` of
    ``csrc/<stem>.cu``, as this process built them."""
    report = ptxas_report(stem, names)
    if not report:
        log(f"{phase} ptxas: the library was not built by this process "
            f"(not reported)")
    for (kname, targs), (regs, st, ld) in sorted(report.items()):
        log(f"{phase} ptxas {kname}<{targs}>: {regs} registers, {st} bytes "
            f"spill stores, {ld} bytes spill loads")


# SASS opcodes by the pipe they issue to (the base name before the first
# dot). "alu" is the integer ALU pipe (64 lanes an SM). The compiler
# moves about a third of the hash's adds to IMAD and VIADD, which issue to
# the FMA pipe at 64 a clock an SM ("imad"); "fp32" is the rest of the
# FMA pipe's work. Conversions with an F64 side count as FP64; "U..."
# opcodes run once a warp on the uniform datapath ("uniform"); loads,
# stores and control are "other". Every class takes issue slots.
SASS_INT = frozenset((
    "IADD3", "IADD", "IADD32I", "IMUL", "LOP3", "LOP", "LOP32I", "SHF",
    "SHL", "SHR", "LEA", "ISETP", "ISET", "IMNMX", "PRMT", "SEL", "MOV",
    "IABS", "POPC", "FLO", "BREV", "BMSK", "SGXT", "VIMNMX", "PLOP3",
    "ISCADD", "BFE", "BFI", "IDP"))
SASS_IMAD = frozenset(("IMAD", "IMAD32I", "VIADD", "VIADDMNMX"))
SASS_FP32 = frozenset((
    "FADD", "FMUL", "FFMA", "FSETP", "FSET", "FMNMX", "FSEL", "MUFU",
    "FCHK", "FRND", "F2FP", "HADD2", "HMUL2", "HFMA2", "HSETP2", "HMNMX2",
    "FSWZADD", "F2F", "F2I", "I2F", "I2FP", "F2IP"))
SASS_FP64 = frozenset(("DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"))


def sass_class(op):
    base = op.split(".")[0]
    if base in SASS_FP64 or (base in ("F2F", "F2I", "I2F") and "F64" in op):
        return "fp64"
    if base in SASS_IMAD:
        return "imad"
    if base in SASS_FP32:
        return "fp32"
    if base in SASS_INT:
        return "alu"
    if base.startswith("U"):
        return "uniform"
    return "other"


def sass_functions(text):
    """{mangled name: (instructions [(address, opcode, operands)], labels
    {name: address})} from ``cuobjdump -sass`` (or nvdisasm) text."""
    import re
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            pending = []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+|\.L_\w+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                cur[1][lab] = addr
            pending = []
            cur[0].append((addr, m.group(2), m.group(3)))
    return funcs


def sass_loops(instrs, labels):
    """[(start, end)] address ranges closed by backward branches, one a
    loop head (its last back edge closes it)."""
    import re
    heads = {}
    for addr, op, args in instrs:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"\((\.L\w+)\)", args) or re.search(r"(\.L_x_\d+)",
                                                          args)
        target = labels.get(m.group(1)) if m else None
        if target is None:
            m = re.search(r"0x([0-9a-f]+)", args)
            target = int(m.group(1), 16) if m else None
        if target is not None and target < addr:
            heads[target] = max(heads.get(target, addr), addr)
    return sorted(heads.items())


def sass_main_loop(instrs, labels):
    """Instruction counts by pipe of the kernel's busiest loop: the loop
    with the most instructions of its own (those of loops nested inside it
    left out), with its address range."""
    loops = sass_loops(instrs, labels)
    best = None
    for lo, hi in loops:
        inner = [(a, b) for a, b in loops if lo <= a and b <= hi
                 and (a, b) != (lo, hi)]
        counts = {}
        for addr, op, _ in instrs:
            if lo <= addr <= hi and not any(a <= addr <= b for a, b in inner):
                c = sass_class(op)
                counts[c] = counts.get(c, 0) + 1
        if best is None or sum(counts.values()) > sum(best[1].values()):
            best = ((lo, hi), counts)
    return best


_SASS = {}          # library path -> sass_functions of it


def sass_counts(lib, kernel, targs, per_iter):
    """Instructions an element by class (sass_class) of kernel
    ``kernel<targs>`` in library ``lib``, from its busiest loop, which
    takes ``per_iter`` elements an iteration: every instruction of the
    loop body once, taken or not."""
    import re
    import shutil
    if lib not in _SASS:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        _SASS[lib] = sass_functions(text)
        dump = os.path.join(HERE, "chiprun_out", "sass")
        os.makedirs(dump, exist_ok=True)
        with open(os.path.join(dump, os.path.basename(str(lib)) + ".txt"),
                  "w") as f:
            f.write(text)
    for name, (instrs, labels) in _SASS[lib].items():
        t = re.search(r"\d" + kernel + r"(I?)", name)
        if t is None:
            continue
        if (template_args(name[t.end():]) if t.group(1) else "") != targs:
            continue
        found = sass_main_loop(instrs, labels)
        if found is None:
            raise SystemExit(f"sass: no loop in {kernel}<{targs}>")
        (lo, hi), counts = found
        out = {k: counts.get(k, 0) / per_iter
               for k in ("alu", "imad", "fp32", "fp64", "uniform", "other")}
        out["loop"] = f"{lo:#x}-{hi:#x}"
        return out
    raise SystemExit(f"sass: no kernel {kernel}<{targs}> in {lib}")


def phase_k4(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    log_ptxas("k4", "flash_attention", K4_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for tag, B, Sq, Sk, H, D, causal, dnames in K4_CASES:
        for dname in dnames:
            dtype = getattr(torch, dname)
            # v and do at half scale: o and the gradients stay below ~3,
            # the size TOL is set for (bf16 output rounding <= 2^-9 |x|)
            q, k = (torch.randn((B * H, n, D), generator=gen, device="cuda")
                    .to(dtype) for n in (Sq, Sk))
            v, do = (torch.randn((B * H, n, D), generator=gen, device="cuda")
                     .mul(0.5).to(dtype) for n in (Sk, Sq))
            scale = D ** -0.5
            o, lse = fa.flash_fwd(q, k, v, scale, causal)
            dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, scale, causal)
            dq2, dk2, dv2 = fa.flash_bwd(q, k, v, o, lse, do, scale, causal)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       ((dq, dq2), (dk, dk2), (dv, dv2)))
            del dq2, dk2, dv2
            f32 = [t.float() for t in (q, k, v, do)]
            ro, rlse = fa._ref_with_lse(f32[0], f32[1], f32[2], scale, causal)
            # the backward's plain version on the very inputs the kernel
            # got: the kernel's own o and lse
            ref_g = fa._ref_bwd(f32[0], f32[1], f32[2], o.float(), lse,
                                f32[3], scale, causal)
            del f32
            pairs = [(o, ro), (lse, rlse)] + list(zip((dq, dk, dv), ref_g))
            errs = [agreement([pr], dname, floor=1e-2) for pr in pairs]
            del ro, rlse, ref_g, pairs
            rel = max(e[1] for e in errs)
            ok = all(e[2] for e in errs) and same and all(
                torch.isfinite(t).all().item() for t in (o, lse, dq, dk, dv))
            log(f"k4 {tag} {dname}: B={B} Sq={Sq} Sk={Sk} H={H} hd={D} "
                f"causal={causal}, max_abs_err o/lse/dq/dk/dv "
                f"{'/'.join(f'{e[0]:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}), backward bitwise repeatable "
                f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k4 {tag} {dname} disagrees with its plain "
                                 f"version")
            if tag in K4_TIMED and dtype == torch.bfloat16:
                k4_time(torch, F, fa, tag, (q, k, v, o, lse, do),
                        (B, Sq, H, D), scale, peak, flush, record, errs,
                        causal)
            del q, k, v, do, o, lse, dq, dk, dv
            torch.cuda.empty_cache()


def profiled_ms(torch, fn, names, flush, iters=10):
    """Device time per call of the kernels whose names hold one of
    ``names``, summed from torch.profiler over ``iters`` calls (L2
    flushed before each): a second reading of the card's clock. None
    when the profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and any(n in e.key for n in names))
    return us / 1e3 / iters if us else None


def k4_time(torch, F, fa, tag, tensors, shape, scale, peak, flush, record,
            errs, causal=True):
    """K4a and K4b at a training shape in bf16 (llama_350m's, the main
    path, goes into the record; Llama-2-7B's; the zoo's non-causal ones
    go into the record's ``shapes``) beside their plain versions and one
    SDPA call (forward; its backward through autograd on a kept graph),
    and their bounds; also forward + backward. The kernels' own times are
    read a second way from torch.profiler."""
    q, k, v, o, lse, do = tensors
    B, S, H, D = shape
    ms_f = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale, causal), torch,
                   flush=flush)
    ms_b = cuda_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, scale,
                                        causal), torch, flush=flush)
    ms_fb = cuda_ms(lambda: fa.flash_bwd(
        q, k, v, *fa.flash_fwd(q, k, v, scale, causal), do, scale,
        causal), torch, flush=flush)
    prof_f = profiled_ms(torch,
                         lambda: fa.flash_fwd(q, k, v, scale, causal),
                         K4_KERNELS[:1], flush)
    prof_b = profiled_ms(torch, lambda: fa.flash_bwd(q, k, v, o, lse, do,
                                                     scale, causal),
                         K4_KERNELS[1:], flush)
    plain_f = cuda_ms(lambda: fa._ref_with_lse(q, k, v, scale, causal),
                      torch, iters=5, flush=flush)
    plain_b = cuda_ms(lambda: fa._ref_bwd(q, k, v, o, lse, do, scale,
                                          causal),
                      torch, iters=5, flush=flush)
    plain_fb = cuda_ms(lambda: fa._ref_bwd(
        q, k, v, *fa._ref_with_lse(q, k, v, scale, causal), do, scale,
        causal), torch, iters=5, flush=flush)
    qs, ks, vs = (t.reshape(B, H, S, D).detach().requires_grad_()
                  for t in (q, k, v))
    dos = do.reshape(B, H, S, D)
    lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, scale=scale), torch, flush=flush)
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                         scale=scale)
    lib_b = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                                retain_graph=True), torch,
                    flush=flush)

    def sdpa_fb():
        o_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                            scale=scale)
        return torch.autograd.grad(o_, (qs, ks, vs), dos)

    lib_fb = cuda_ms(sdpa_fb, torch, flush=flush)
    del out
    elt = q.element_size()
    n = B * H * S * D * elt
    flops_f = (2 if causal else 4) * B * H * S * S * D   # causal: half
    bound_f, by_f = bound(4 * n + 4 * B * H * S, flops_f, peak)
    bound_b, by_b = bound(8 * n + 4 * B * H * S, 2.5 * flops_f, peak)
    bound_fb, _ = bound(9 * n + 4 * B * H * S, 3.5 * flops_f, peak)
    if tag == "350m":
        record["flash_attention_fwd"].update(
            max_abs_err=max(errs[0][0], errs[1][0]), ms=ms_f,
            plain_ms=plain_f, library_ms=lib_f, bound_ms=bound_f,
            bound_by=by_f)
        record["flash_attention_bwd"].update(
            max_abs_err=max(e[0] for e in errs[2:]), ms=ms_b,
            plain_ms=plain_b, library_ms=lib_b, bound_ms=bound_b,
            bound_by=by_b)
    if tag in ("dit_s_4", "vit_l_14"):
        for kname, ms, plain, lib, bnd, by in (
                ("flash_attention_fwd", ms_f, plain_f, lib_f, bound_f, by_f),
                ("flash_attention_bwd", ms_b, plain_b, lib_b, bound_b,
                 by_b)):
            record[kname].setdefault("shapes", {})[tag] = {
                "shape": [B, S, H, D], "causal": causal, "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
                "bound_by": by}
    for what, ms, plain, lib, bnd, seen in (
            ("forward", ms_f, plain_f, lib_f, bound_f,
             ", profiler " + fmt_ms(prof_f)),
            ("backward", ms_b, plain_b, lib_b, bound_b,
             ", profiler " + fmt_ms(prof_b)),
            ("forward+backward", ms_fb, plain_fb, lib_fb, bound_fb, "")):
        log(f"k4 {tag} bf16 {what} timing: kernel {ms:.4f} ms{seen}, plain "
            f"{plain:.4f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound "
            f"{bnd:.4f} ms")


K5_KERNELS = ("rms_fwd_kernel", "rms_bwd_kernel", "rms_dw_reduce_kernel")


def phase_k5(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    log_ptxas("k5", "rms_norm", K5_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps = 1e-5
    # llama_350m's and Llama-2-7B's rows; a ragged width (33 chunks of 16
    # bytes in bf16: most lanes masked) with fewer rows than row groups;
    # moe_350m_8e's rows (768 wide: 96 threads forward, a masked chunk on
    # every lane backward)
    for tag, rows, d in (("350m", 8192, 1024), ("7b", 4096, 4096),
                         ("ragged", 1000, 264), ("moe", 8192, 768)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            # the output is x / rms(x) * w whatever the scale of x: w ~
            # 0.5 keeps it below ~3, the size TOL is set for; g at
            # rows^-1/2 keeps dw, a sum over every row, near 1
            w = (0.5 + 0.05 * torch.randn((d,), generator=gen, device="cuda")
                 ).to(dtype)
            g = (torch.randn((rows, d), generator=gen, device="cuda")
                 * rows ** -0.5).to(dtype)
            out = rn.rms_norm_fwd(x, w, eps)
            dx, dw = rn.rms_norm_bwd(x, w, g, eps)
            dx2, dw2 = rn.rms_norm_bwd(x, w, g, eps)
            torch.cuda.synchronize()
            same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
            ro = rn._ref_fwd(x.float(), w.float(), eps)
            rdx, rdw = rn._ref_bwd(x.float(), w.float(), g.float(), eps)
            errs = [agreement([pr], dname, floor=1e-2) for pr in
                    ((out, ro), (dx, rdx), (dw[None], rdw[None]))]
            rel = max(e[1] for e in errs)
            ok = all(e[2] for e in errs) and same and all(
                torch.isfinite(t).all().item() for t in (out, dx, dw))
            log(f"k5 {tag} {dname}: {rows} x {d}, max_abs_err out/dx/dw "
                f"{'/'.join(f'{e[0]:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}), backward bitwise repeatable "
                f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k5 {tag} {dname} disagrees with its plain "
                                 f"version")
            if dtype == torch.bfloat16 and tag in ("350m", "7b"):
                k5_time(torch, F, rn, tag, x, w, g, eps, peak, flush, record,
                        errs)


def k5_time(torch, F, rn, tag, x, w, g, eps, peak, flush, record, errs):
    """K5a and K5b in bf16 beside their plain versions and
    F.rms_norm (forward; its backward through autograd on a kept graph),
    yardsticks the port never calls, and their bounds; the backward's
    row kernel and its dw reduction also read apart from torch.profiler.
    llama_350m's shape (the train path's) goes into the record."""
    rows, d = x.shape
    ms_f = cuda_ms(lambda: rn.rms_norm_fwd(x, w, eps), torch, flush=flush)
    ms_b = cuda_ms(lambda: rn.rms_norm_bwd(x, w, g, eps), torch, flush=flush)
    prof_rows, prof_dw = (profiled_ms(
        torch, lambda: rn.rms_norm_bwd(x, w, g, eps), names, flush)
        for names in (K5_KERNELS[1:2], K5_KERNELS[2:]))
    plain_f = cuda_ms(lambda: rn._ref_fwd(x, w, eps), torch, flush=flush)
    plain_b = cuda_ms(lambda: rn._ref_bwd(x, w, g, eps), torch, flush=flush)
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    lib_f = cuda_ms(lambda: F.rms_norm(xs, (d,), ws, eps), torch,
                    flush=flush)
    y = F.rms_norm(xs, (d,), ws, eps)
    lib_b = cuda_ms(lambda: torch.autograd.grad(
        y, (xs, ws), g, retain_graph=True), torch, flush=flush)
    elt = x.element_size()
    bound_f, by_f = bound((2 * rows * d + d) * elt, 0, peak)
    bound_b, by_b = bound((3 * rows * d + 2 * d) * elt, 0, peak)
    if tag == "350m":
        record["rms_norm_fwd"].update(
            max_abs_err=errs[0][0], ms=ms_f, plain_ms=plain_f,
            library_ms=lib_f, bound_ms=bound_f, bound_by=by_f)
        record["rms_norm_bwd"].update(
            max_abs_err=max(errs[1][0], errs[2][0]), ms=ms_b,
            plain_ms=plain_b, library_ms=lib_b, bound_ms=bound_b,
            bound_by=by_b)
    for what, ms, plain, lib, bnd, seen in (
            ("forward", ms_f, plain_f, lib_f, bound_f, ""),
            ("backward", ms_b, plain_b, lib_b, bound_b,
             f" (profiler: rows {fmt_ms(prof_rows)}, dw reduction "
             f"{fmt_ms(prof_dw)}, from its start: a programmatic "
             f"dependent launch starts under the rows' tail and waits)")):
        log(f"k5 {tag} bf16 {what} timing: kernel {ms:.4f} ms{seen}, plain "
            f"{plain:.4f} ms, F.rms_norm {lib:.4f} ms, bound {bnd:.4f} ms")


# (tag, B, S, Hq, Hk, D, table rows, offset view): one tensor (Hk = 0)
# at llama_350m's q, Llama-2-7B's q and a tail (S = 1000, no power of
# two); q and k in one launch at llama_350m (the train path's), 7B and
# Llama-2-70B's GQA heads (64 over 8); the scalar body at D = 72 (D/2 =
# 36: no whole 16-byte chunks of bf16; f32 takes 9 chunks of 4) and on
# views 2 or 4 bytes past 16-byte alignment; q and k at moe_350m_8e's
# training step (12 heads of 64, its 1024-row table)
K6_CASES = (("350m", 8, 1024, 16, 0, 64, 2048, False),
            ("7b", 1, 4096, 32, 0, 128, 4096, False),
            ("tail", 2, 1000, 8, 0, 128, 2048, False),
            ("350m-qk", 8, 1024, 16, 16, 64, 2048, False),
            ("7b-qk", 1, 4096, 32, 32, 128, 4096, False),
            ("70b-gqa-qk", 2, 1024, 64, 8, 128, 4096, False),
            ("d72-qk", 2, 512, 8, 8, 72, 1024, False),
            ("offset-qk", 2, 512, 16, 4, 64, 1024, True),
            ("moe-qk", 8, 1024, 12, 12, 64, 1024, False))
K6_KERNELS = ("rope_kernel",)


def k6_route(tag, dtype):
    """The route a K6 case must take."""
    if tag.startswith("offset") or (tag.startswith("d72")
                                    and dtype == "bfloat16"):
        return "scalar"
    return "vector"


def k6_inputs(torch, gen, B, S, H, D, dtype, offset):
    """x [B, S, H, D] at half scale (a rotation keeps each pair's norm,
    so outputs stay below ~3, the size TOL is set for); with ``offset``
    a contiguous view one element past a 16-byte boundary."""
    n = B * S * H * D
    flat = (0.5 * torch.randn((n + 8,), generator=gen, device="cuda")
            ).to(dtype)
    return flat[1:1 + n].view(B, S, H, D) if offset else \
        flat[:n].view(B, S, H, D)


def k6_case(torch, rk, q, k, cos, sin, dname):
    """Both signs, each launched twice into outputs poisoned with NaN:
    (max_abs_err, vector-relative error, within tolerance, bit for bit
    the plain version, bitwise repeat, finite, routes taken)."""
    errs, same, repeat, finite, routes = [], True, True, True, set()
    for sign in (1, -1):
        ref = (rk._ref_rope(q, cos, sin, sign),
               None if k is None else rk._ref_rope(k, cos, sin, sign))
        outs = []
        for _ in range(2):
            buf = tuple(None if t is None else
                        torch.full_like(t, float("nan")) for t in (q, k))
            out, path = rk._launch(q, k, cos, sin, sign, out=buf)
            outs.append(out)
            routes.add(path)
        torch.cuda.synchronize()
        for o, o2, r in zip(outs[0], outs[1], ref):
            if r is None:
                continue
            errs.append(agreement([(o, r.float())], dname))
            same &= torch.equal(o, r)
            repeat &= torch.equal(o, o2)
            finite &= bool(torch.isfinite(o).all().item())
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs), same, repeat, finite, routes)


def phase_k6(torch, peak, flush, record):
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.ops.rope import precompute_freqs
    log_ptxas("k6", "rope", K6_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for tag, B, S, hq, hk, D, rows, offset in K6_CASES:
        for tname in ("float32", "bfloat16"):
            cos, sin = precompute_freqs(D, rows, dtype=getattr(torch, tname),
                                        device="cuda")
            for dname in ("bfloat16", "float32"):
                dtype = getattr(torch, dname)
                q = k6_inputs(torch, gen, B, S, hq, D, dtype, offset)
                k = k6_inputs(torch, gen, B, S, hk, D, dtype, offset) \
                    if hk else None
                err, rel, within, same, repeat, finite, routes = k6_case(
                    torch, rk, q, k, cos, sin, dname)
                want = k6_route(tag, dname)
                ok = within and same and repeat and finite \
                    and routes == {want}
                worst = max(worst, err)
                log(f"k6 {tag} {dname} x, {tname} tables: B={B} S={S} "
                    f"Hq={hq} Hk={hk} D={D}, table {rows} rows, route "
                    f"{sorted(routes)} (want {want}), max_abs_err fwd+bwd "
                    f"{err:.2e} (tol {TOL[dname]:.0e}), max vector-relative"
                    f" error {rel:.3e} (tol {VEC_RTOL[dname]:.0e}), bit for"
                    f" bit the plain version {same}, twice into NaN "
                    f"bitwise equal {repeat} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"k6 {tag} {dname} x, {tname} tables:"
                                     f" disagrees with its plain version or"
                                     f" is off its route")
                if tname == "float32" and dname == "bfloat16" \
                        and tag in ("350m", "7b", "350m-qk", "7b-qk"):
                    k6_time(torch, rk, tag, q, k, cos, sin, peak, flush,
                            record)
                del q, k
    record["rope"]["max_abs_err"] = worst
    k6_bf16_tables(torch, gen)


def k6_time(torch, rk, tag, q, k, cos, sin, peak, flush, record):
    """The launch beside its plain version and its bytes bound (each
    tensor read and written once, the table's first S rows of cos and sin
    read once; 6 operations a pair, no tensor-core work): forward and
    backward. llama_350m's go into the record (the one-tensor launch as
    ``ms``, the q + k launch the train step makes as ``qk_ms``)."""
    S, D = q.shape[1], q.shape[3]
    if k is None:
        def kern(sign):
            return rk.rope_fwd(q, cos, sin, sign)

        def plain(sign):
            return rk._ref_rope(q, cos, sin, sign)
    else:
        def kern(sign):
            return rk.rope_qk_fwd(q, k, cos, sin, sign)

        def plain(sign):
            return rk._ref_rope_qk(q, k, cos, sin, sign)
    ms_f, ms_b, plain_f, plain_b = (
        cuda_ms(lambda: fn(sign), torch, flush=flush)
        for fn, sign in ((kern, 1), (kern, -1), (plain, 1), (plain, -1)))
    n = q.numel() + (0 if k is None else k.numel())
    nbytes = 2 * n * q.element_size() + 2 * S * D // 2 * cos.element_size()
    bound_ms, by = bound(nbytes, 3 * n, peak, peak[2])
    if tag == "350m":
        record["rope"].update(ms=ms_f, plain_ms=plain_f, library_ms=None,
                              bound_ms=bound_ms, bound_by=by)
    elif tag == "350m-qk":
        record["rope"].update(qk_ms=ms_f, qk_backward_ms=ms_b,
                              qk_plain_ms=plain_f, qk_bound_ms=bound_ms)
    log(f"k6 {tag} bf16 timing ({list(q.shape)}"
        f"{'' if k is None else f' + {list(k.shape)}'}, f32 tables): kernel"
        f" forward {ms_f:.4f} ms, backward {ms_b:.4f} ms; plain composition "
        f"forward {plain_f:.4f} ms, backward {plain_b:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({by}; {nbytes} bytes): forward at "
        f"{100 * bound_ms / ms_f:.0f}% of it, backward "
        f"{100 * bound_ms / ms_b:.0f}%")


def k6_bf16_tables(torch, gen):
    """bf16 cos/sin tables, as the reference's kernel takes the tables'
    type, at llama_350m's q (and k) in bf16 and f32:
    ``apply_rotary_kernel`` and ``apply_rotary_qk_kernel`` forward and
    backward must take the kernel route (two launches of each wrapper)
    and agree with the plain composition bit for bit."""
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.ops.rope import precompute_freqs
    _, B, S, H, _, D, rows, _ = K6_CASES[0]
    shape = (B, S, H, D)
    cos, sin = precompute_freqs(D, rows, dtype=torch.bfloat16, device="cuda")
    x0, g0, k0, gk0 = (0.5 * torch.randn(shape, generator=gen,
                                         device="cuda") for _ in range(4))
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        x, k = (t.to(dtype).requires_grad_() for t in (x0, k0))
        g, gk = g0.to(dtype), gk0.to(dtype)
        before = rk.rope_fwd.launches, rk.rope_qk_fwd.launches
        out = rk.apply_rotary_kernel(x, cos, sin)
        (dx,) = torch.autograd.grad(out, x, g)
        oq, ok = rk.apply_rotary_qk_kernel(x, k, cos, sin)
        dq, dk = torch.autograd.grad((oq, ok), (x, k), (g, gk))
        torch.cuda.synchronize()
        launched = (rk.rope_fwd.launches - before[0],
                    rk.rope_qk_fwd.launches - before[1])
        pairs = [(out, rk._ref_rope(x.detach(), cos, sin, 1)),
                 (dx, rk._ref_rope(g, cos, sin, -1)),
                 (oq, rk._ref_rope(x.detach(), cos, sin, 1)),
                 (ok, rk._ref_rope(k.detach(), cos, sin, 1)),
                 (dq, rk._ref_rope(g, cos, sin, -1)),
                 (dk, rk._ref_rope(gk, cos, sin, -1))]
        errs = [agreement([(a.detach(), b.float())], dname) for a, b in pairs]
        same = all(torch.equal(a, b) for a, b in pairs)
        ok_ = all(e[2] for e in errs) and same and launched == (2, 2)
        log(f"k6 bf16 tables, {dname} x {list(shape)}: route kernel "
            f"({launched[0]} single and {launched[1]} q + k launches for "
            f"forward + backward, expected 2 and 2), max_abs_err "
            f"{max(e[0] for e in errs):.2e} (tol {TOL[dname]:.0e}), bit for "
            f"bit the plain version {same} {'ok' if ok_ else 'FAIL'}")
        if not ok_:
            raise SystemExit(f"k6 bf16 tables {dname}: not on the kernel "
                             f"route, or disagrees with the plain version")


# (tag, M, K, N, bias, activation, bf16 route): GPT-2 345M's FFN at 4096
# rows (8 x 512; benchmarks/decode_bench.py:24-26), Llama-2-7B's gate
# projection, relu, an N tail that is a multiple of 8 but not of the 128
# tile, ragged M, N and K (multiples of 8: TMA zero-fills the edges), then
# K and N odd, which only the masked element loads take. f32 runs simt.
K7_CASES = (("gpt2-ffn1", 4096, 1024, 4096, True, "gelu", "wgmma"),
            ("gpt2-ffn2", 4096, 4096, 1024, True, "none", "wgmma"),
            ("7b-gate", 4096, 4096, 11008, False, "none", "wgmma"),
            ("relu", 4096, 1024, 4096, True, "relu", "wgmma"),
            ("n-tail", 4096, 1024, 1000, True, "gelu", "wgmma"),
            ("ragged", 1000, 1000, 1000, True, "gelu", "wgmma"),
            ("ragged-odd", 999, 777, 333, True, "relu", "mma_sync"))


def k7_inputs(torch, gen, M, K, N, has_bias, dtype):
    """x, w, bias and a cotangent: w at 0.5 / sqrt(K) keeps the
    pre-activation near N(0, 1/4), below ~3 (the size TOL is set for);
    the cotangent at 0.5 / sqrt(M) keeps dw and db, sums over M rows,
    near that size too."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=gen, device="cuda")
         * (0.5 / K ** 0.5)).to(dtype)
    b = (0.1 * torch.randn((N,), generator=gen, device="cuda")).to(dtype) \
        if has_bias else None
    g = (torch.randn((M, N), generator=gen, device="cuda")
         * (0.5 / M ** 0.5)).to(dtype)
    return x, w, b, g


def phase_k7(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import gemm_epilogue as ge
    gen = torch.Generator(device="cuda").manual_seed(7)
    for tag, M, K, N, has_bias, act, bf16_route in K7_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            want = bf16_route if dtype == torch.bfloat16 else "simt"
            x, w, b, g = k7_inputs(torch, gen, M, K, N, has_bias, dtype)
            leaves = [t.detach().requires_grad_() for t in (x, w)] + \
                ([b.detach().requires_grad_()] if has_bias else [])
            before = dict(ge.gemm_epilogue.route_launches)
            out = ge.fused_gemm_epilogue(*leaves[:2],
                                         leaves[2] if has_bias else None, act)
            took = [r for r, n in ge.gemm_epilogue.route_launches.items()
                    if n != before[r]]
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            # the plain version in f32, its backward through autograd
            ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
            ref = ge._ref_gemm_epilogue(
                *ref_leaves[:2], ref_leaves[2] if has_bias else None, act)
            ref_grads = torch.autograd.grad(ref, ref_leaves, g.float())
            pairs = [(out, ref.detach())] + [      # db as one row
                (gr.reshape(-1, gr.shape[-1]), rg.reshape(-1, rg.shape[-1]))
                for gr, rg in zip(grads, ref_grads)]
            errs = [agreement([pr], dname, floor=1e-2) for pr in pairs]
            del ref, ref_grads, ref_leaves, pairs
            ok = all(e[2] for e in errs) and torch.isfinite(out).all().item() \
                and all(torch.isfinite(t).all().item() for t in grads) \
                and took == [want]
            log(f"k7 {tag} {dname}: [{M}, {K}] @ [{K}, {N}]"
                f"{' + bias' if has_bias else ''}, {act}, route {took} "
                f"(expected {want}), max_abs_err out/"
                f"dx/dw{'/db' if has_bias else ''} "
                f"{'/'.join(f'{e[0]:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error "
                f"{max(e[1] for e in errs):.3e} (tol {VEC_RTOL[dname]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k7 {tag} {dname} disagrees with its plain "
                                 f"version")
            if dtype == torch.bfloat16 and tag in ("gpt2-ffn1", "7b-gate"):
                k7_time(torch, F, ge, tag, x, w, b, act, peak, flush, record,
                        errs[0][0])
            del x, w, b, g, leaves, out, grads
    record["gemm_epilogue"]["launches"] = k7_main_path(torch, gen)
    torch.cuda.empty_cache()


def k7_time(torch, F, ge, tag, x, w, b, act, peak, flush, record, err):
    """K7 forward beside its plain version and torch.addmm followed by
    the activation (a yardstick the port never calls), and its bound."""
    M, K = x.shape
    N = w.shape[1]
    ms = cuda_ms(lambda: ge.gemm_epilogue(x, w, b, act), torch, flush=flush)
    plain_ms = cuda_ms(lambda: ge._ref_gemm_epilogue(x, w, b, act), torch,
                       flush=flush)
    zero = torch.zeros((N,), dtype=x.dtype, device="cuda")
    lib_act = {"gelu": lambda t: F.gelu(t, approximate="tanh"),
               "relu": F.relu, "none": lambda t: t}[act]
    lib_ms = cuda_ms(lambda: lib_act(torch.addmm(
        b if b is not None else zero, x, w)), torch, flush=flush)
    elt = x.element_size()
    nbytes = (M * K + K * N + M * N + (N if b is not None else 0)) * elt
    bound_ms, by = bound(nbytes, 2 * M * N * K, peak)
    if tag == "gpt2-ffn1":
        record["gemm_epilogue"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by)
    log(f"k7 {tag} bf16 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"addmm + {act} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
        f"{nbytes} bytes, {2 * M * N * K} flops)")


def k7_main_path(torch, gen):
    """GPT-2 345M's FFN at 4096 rows in bf16 through the incubate entry
    points, forward and backward: ``fused_linear_activation`` (gelu)
    then ``fused_matmul_bias``. The counters are zeroed just before and
    read just after: K7 twice, both on the wgmma route (the backward is
    torch.matmul, as in the reference), no other kernel. Returns K7's
    count."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.kernels import gemm_epilogue as ge
    x, w1, b1, _ = k7_inputs(torch, gen, 4096, 1024, 4096, True,
                             torch.bfloat16)
    _, w2, b2, gy = k7_inputs(torch, gen, 4096, 4096, 1024, True,
                              torch.bfloat16)
    leaves = [t.requires_grad_() for t in (x, w1, b1, w2, b2)]
    zero_counts()
    ge.gemm_epilogue.route_launches = dict.fromkeys(ge.ROUTES, 0)
    h = IF.fused_linear_activation(x, w1, b1, activation="gelu")
    y = IF.fused_matmul_bias(h, w2, b2)
    grads = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    counts = read_counts()
    routes = dict(ge.gemm_epilogue.route_launches)
    with torch.no_grad():
        ref = ge._ref_gemm_epilogue(
            ge._ref_gemm_epilogue(x, w1, b1, "gelu"), w2, b2, "none")
    err, rel, close = agreement([(y, ref.float())], "bfloat16")
    ok = close and counts["k7"] == 2 and routes["wgmma"] == 2 and not any(
        v for k, v in counts.items() if k != "k7") and all(
        torch.isfinite(t).all().item() for t in (y, *grads))
    log(f"k7 main path: GPT-2 345M FFN [4096, 1024] bf16 through "
        f"fused_linear_activation + fused_matmul_bias, forward and backward:"
        f" launches {counts}, by route {routes}, max_abs_err against the "
        f"plain chain {err:.2e}"
        f" (tol {TOL['bfloat16']:.0e}), max vector-relative error {rel:.3e}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("k7 main path: the incubate entry points did not "
                         "run K7 as counted (twice, on the wgmma route), or "
                         "disagree with the plain chain")
    return counts["k7"]


# (tag, M, K, N): Llama-2-7B's projections at 4096 rows (8 x 512 tokens):
# q/k/v/o, gate/up, down and the head; a decode batch; ragged M; M, K and
# N past the wgmma tile's multiples (128, 128, 256); then K and N off
# TMA's multiples (the mma.sync route)
K8_CASES = (("7b-qkvo", 4096, 4096, 4096), ("7b-gate-up", 4096, 4096, 11008),
            ("7b-down", 4096, 11008, 4096), ("7b-head", 4096, 4096, 32000),
            ("decode", 8, 4096, 11008), ("ragged-m", 1000, 4096, 4096),
            ("tails", 200, 1040, 1000), ("ragged-all", 77, 1000, 1002))


K8_KERNELS = ("qmm_wgmma_kernel", "qmm_kernel")


def phase_k8(torch, peak, flush, record):
    """Every case through the reference layout's entry (its K-major copy
    made on the card) in f32 and bf16 out, on its stated route, bitwise
    equal to the plain version; the 7B cases also through the K-major
    entry the main path calls. Then each case's launch into an output
    poisoned with NaN, twice: every element written, bitwise equal to
    the plain version and between the two launches."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    log_ptxas("k8", "quant_matmul", K8_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(8)
    f32, bf16 = torch.float32, torch.bfloat16
    for tag, M, K, N in K8_CASES:
        want = "mma_sync" if tag == "ragged-all" else "wgmma"
        x = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        wt = w.t().contiguous()
        sx = torch.tensor(0.0123, device="cuda")
        sw = 1e-3 + 1e-2 * torch.rand((N,), generator=gen, device="cuda")
        ref = qm._ref(x, w, sx, sw)
        entries = [("reference layout", qm.quantized_matmul, w)]
        if tag.startswith("7b"):
            entries.append(("K-major", qm.quantized_matmul_kmajor, wt))
        checks, err = {}, 0.0
        for name, fn, weight in entries:
            for dt in (f32, bf16):
                before = dict(qm.quantized_matmul.route_launches)
                out = fn(x, weight, sx, sw, out_dtype=dt)
                took = [r for r, n in qm.quantized_matmul.route_launches
                        .items() if n != before[r]]
                torch.cuda.synchronize()
                checks[f"{name} {str(dt)[6:]} on {took}"] = \
                    torch.equal(out, ref.to(dt)) and took == [want]
                if dt == f32:
                    err = max(err, (out - ref).abs().max().item())
                del out
        sxs, sws = qm._scales(sx, sw, N, x.device)
        for dt in (f32, bf16):
            a, b = (torch.full((M, N), float("nan"), dtype=dt, device="cuda")
                    for _ in range(2))
            qm._launch(x, wt, sxs, sws, a)
            qm._launch(x, wt, sxs, sws, b)
            torch.cuda.synchronize()
            checks[f"poisoned {str(dt)[6:]} twice"] = torch.equal(
                a, ref.to(dt)) and torch.equal(a, b)
            del a, b
        ok = all(checks.values())
        log(f"k8 {tag}: [{M}, {K}] @ [{K}, {N}] int8, route {want}; bitwise "
            f"equal to the plain version: {checks} (max_abs_err {err:.2e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"k8 {tag} disagrees with its plain version, "
                             f"took another route, or is not repeatable")
        del ref
        if tag == "7b-gate-up":
            k8_time(torch, qm, x, w, wt, sx, sw, peak, flush, record, err)
        del x, w, wt
    torch.cuda.empty_cache()


def k8_time(torch, qm, x, w, wt, sx, sw, peak, flush, record, err):
    """K8 through the main path's entry (the K-major weight, bf16 out, as
    ``Int8InferLinear`` calls it; f32 out beside it) against its plain
    version (an f64 product) and torch._int_mm with the same epilogue (a
    yardstick the port never calls), and its bound at the int8
    tensor-core peak; for information, bf16 torch.addmm and K7's bf16
    route at the same shape."""
    from paddle_tpu_torch.ops.kernels import gemm_epilogue as ge
    M, K = x.shape
    N = w.shape[1]
    bf16 = torch.bfloat16
    ms = cuda_ms(lambda: qm.quantized_matmul_kmajor(x, wt, sx, sw,
                                                    out_dtype=bf16),
                 torch, flush=flush)
    ms_f32 = cuda_ms(lambda: qm.quantized_matmul_kmajor(x, wt, sx, sw),
                     torch, flush=flush)
    plain_ms = cuda_ms(lambda: qm._ref(x, w, sx, sw, bf16), torch, iters=5,
                       flush=flush)
    try:
        lib_ms = cuda_ms(lambda: torch._int_mm(x, w).float() * sx
                         * sw[None, :], torch, flush=flush)
    except RuntimeError as e:        # the yardstick only; nothing depends
        lib_ms = None
        log(f"k8: torch._int_mm refused these operands ({e}); library_ms "
            f"not measured")
    xb, wb = x.to(bf16), w.to(bf16)
    zero = torch.zeros((N,), dtype=bf16, device="cuda")
    addmm_ms = cuda_ms(lambda: torch.addmm(zero, xb, wb), torch, flush=flush)
    k7_ms = cuda_ms(lambda: ge.gemm_epilogue(xb, wb), torch, flush=flush)
    del xb, wb
    nbytes = M * K + K * N + 4 + 4 * N + 2 * M * N
    bound_ms, by = bound(nbytes, 2 * M * N * K, peak, peak[3])
    record["quant_matmul"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound_ms, bound_by=by)
    log(f"k8 7b-gate-up timing: kernel {ms:.4f} ms (K-major, bf16 out; f32 "
        f"out {ms_f32:.4f} ms), plain {plain_ms:.4f} ms, _int_mm + epilogue "
        f"{'not measured' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{bound_ms:.4f} ms ({by}; {nbytes} bytes, {2 * M * N * K} int8 "
        f"operations); for information, bf16 at the same shape: addmm "
        f"{addmm_ms:.4f} ms, K7 wgmma {k7_ms:.4f} ms")


def llama_350m_shapes():
    """The shapes of llama_350m's 219 parameters, in the model's order:
    373,867,520 elements."""
    from paddle_tpu_torch.models import llama_350m
    cfg = llama_350m()
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    layer = [("input_layernorm", (h,)), ("q_proj", (h, h)),
             ("k_proj", (h, kv)), ("v_proj", (h, kv)), ("o_proj", (h, h)),
             ("post_attention_layernorm", (h,)), ("gate_proj", (h, m)),
             ("up_proj", (h, m)), ("down_proj", (m, h))]
    return ([("model.embed_tokens.weight", (v, h))]
            + [(f"model.layers.{i}.{n}", s) for i in range(cfg.num_layers)
               for n, s in layer]
            + [("model.norm.weight", (h,)), ("lm_head.weight", (h, v))])


# (tag, parameter dtype name, f32 masters): the train phase's case, the
# slice's path (train_amp: bf16 with masters) and f32 parameters
OPT_CASES = (("bf16", "bfloat16", False), ("bf16_mp", "bfloat16", True),
             ("f32", "float32", False))
OPT_LR, OPT_STEPS = 1e-3, 3


def opt_bytes(dtype_bytes, master):
    """Bytes an element the step must move: g, the parameter (or its
    master, which the update reads instead), m and v read; the parameter
    (and master), m and v written."""
    read = dtype_bytes + (4 if master else dtype_bytes) + 8
    write = dtype_bytes + (4 if master else 0) + 8
    return read + write


def opt_state(torch, params, master):
    m = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for p in params]
    v = [torch.zeros_like(t) for t in m]
    mp = [p.float() for p in params] if master else [None] * len(params)
    return [params, m, v, mp]


def opt_clone(st):
    return [[None if t is None else t.clone() for t in part] for part in st]


def opt_run(mta, grads, st, wds, clip, plain=False, scales=None):
    """OPT_STEPS AdamW steps over the state ``st`` (params, m, v,
    masters) in place: the kernel (through the wrapper) or the plain
    version (with the kernel's clip scales, when given). Returns each
    step's [scale, norm] tensor (or None)."""
    infos, cache = [], {}
    for s in range(OPT_STEPS):
        g = grads[s]
        kw = dict(lr=OPT_LR, beta1=0.9, beta2=0.999, epsilon=1e-8,
                  step=1 + s, decoupled=True)
        if not plain:
            infos.append(mta.multi_tensor_adam(
                g, st[0], st[1], st[2], st[3], wds, clip_norm=clip,
                cache=cache, **kw))
        else:
            infos.append(mta._ref_multi_tensor_adam(
                g, st[0], st[1], st[2], st[3], wds, kw["lr"], kw["beta1"],
                kw["beta2"], kw["epsilon"], kw["step"], True,
                None if scales else clip,
                None if not scales else scales[s][0]))
    return infos


def bits(torch, t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def opt_equal(torch, a, b):
    """Whether two states are equal bit for bit."""
    return all((x is None and y is None) or torch.equal(bits(torch, x),
                                                        bits(torch, y))
               for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def opt_against(torch, got, want, dtype):
    """The kernel's state against the plain version's on the card
    (ROADMAP Queue 3's Adam rule): m and v and f32 parameters or masters
    within two f32 ulps plus 1e-5 lr an element; bf16 parameters at most
    one bf16 ulp apart a step (an f32 value an ulp apart that crosses a
    bf16 rounding midpoint; a parameter without a master carries the
    flip into the next step, an ulp of its value then, at most |value|
    plus the steps' updates), on at most 1e-4 of the elements. Returns
    (largest absolute error of the parameters, fraction of bf16 elements
    that differ, ok)."""
    err, flips, total, ok = 0.0, 0, 0, True
    for part, (pa, pb) in enumerate(zip(got, want)):
        for x, y in zip(pa, pb):
            if x is None:
                continue
            d = (x.float() - y.float()).abs()
            if part == 0:
                err = max(err, d.max().item())
            if x.dtype == torch.bfloat16:
                # a flip at an earlier step is an ulp of the value then:
                # at most |y| plus the steps' updates (~lr each)
                ulp = torch.exp2(torch.floor(torch.log2(
                    y.float().abs() + OPT_STEPS * OPT_LR)) - 7)
                good = bool((d <= OPT_STEPS * ulp).all())
                flips += int((d > 0).sum())
                total += d.numel()
            else:
                lim = 2.5e-7 * y.abs() + (1e-5 * OPT_LR if part in (0, 3)
                                          else 0.0)
                good = bool((d <= lim).all())
            if not good:
                i = int((d - (OPT_STEPS * ulp if x.dtype == torch.bfloat16
                              else lim)).argmax())
                log(f"opt: {('param', 'm', 'v', 'master')[part]} "
                    f"{tuple(x.shape)} {x.dtype} off the rule: kernel "
                    f"{x.flatten()[i].item()!r}, plain "
                    f"{y.flatten()[i].item()!r}")
            ok &= good
    frac = flips / max(total, 1)
    return err, frac, ok and frac <= 1e-4


def opt_poison_check(torch, mta, gen):
    """Ragged, one-element and misaligned tensors (16-byte body and
    scalar tail) packed into buffers with NaN gaps, beside a tensor that
    is not live: three steps of the kernel, with and without the clip,
    each dtype and a mixed set: bit for bit the plain version run on the
    CPU (given the kernel's clip scale), every NaN gap and the tensor
    that is not live untouched."""
    sizes = [1, 3, 7, 8, 9, 1000, 16384, 16385, 40000]
    good = True
    for kinds in (("float32",), ("bfloat16",), ("bfloat16m",),
                  ("float32", "bfloat16m", "bfloat16", "float16")):
        for clip in (None, 1.0):
            bufs, views = [], []
            for i, n in enumerate(sizes):
                kind = kinds[i % len(kinds)]
                dt = getattr(torch, kind.rstrip("m"))
                off = 8 + (i % 2)                       # odd: misaligned
                made = []
                for what, t_dt in (("p", dt), ("m", torch.float32),
                                   ("v", torch.float32),
                                   ("mp", torch.float32)):
                    if what == "mp" and not kind.endswith("m"):
                        made.append((None, None))
                        continue
                    buf = torch.full((n + 40,), float("nan"), dtype=t_dt,
                                     device="cuda")
                    view = buf[off:off + n]
                    made.append((buf, view))
                (pb, p), (mb, m), (vb, v), (mpb, mp) = made
                p.copy_(torch.randn(n, generator=gen, device="cuda") * 0.1)
                m.zero_()
                v.zero_()
                if mp is not None:
                    mp.copy_(p.float())
                gs = [(torch.randn(n, generator=gen, device="cuda")
                       * 0.05).to(dt) for _ in range(OPT_STEPS)]
                bufs.append([pb, mb, vb, mpb])
                views.append([p, m, v, mp, gs, 0.0 if i % 3 == 0 else 0.01])
            live = views[:-1]                        # the last is not live
            cpu = [[x.cpu() if x is not None else None for x in b]
                   for b in bufs]
            st = [[v_[k] for v_ in live] for k in range(4)]
            grads = [[v_[4][s] for v_ in live] for s in range(OPT_STEPS)]
            wds = [v_[5] for v_ in live]
            infos = opt_run(mta, grads, st, wds, clip)
            torch.cuda.synchronize()
            # the same on the CPU copies of the buffers
            cviews = []
            for (p, m, v, mp, gs, wd), cb in zip(views, cpu):
                off, n = p.storage_offset(), p.numel()
                cviews.append([cb[0][off:off + n], cb[1][off:off + n],
                               cb[2][off:off + n],
                               None if cb[3] is None else
                               cb[3][off:off + n],
                               [g.cpu() for g in gs], wd])
            clive = cviews[:-1]
            cst = [[v_[k] for v_ in clive] for k in range(4)]
            cgrads = [[v_[4][s] for v_ in clive] for s in range(OPT_STEPS)]
            scales = None if clip is None else [i.cpu() for i in infos]
            opt_run(mta, cgrads, cst, [v_[5] for v_ in clive], clip,
                    plain=True, scales=scales)
            same = all(
                (a is None and b is None)
                or torch.equal(bits(torch, a.cpu()), bits(torch, b))
                for ba, bb in zip(bufs, cpu) for a, b in zip(ba, bb))
            log(f"opt poison {'+'.join(kinds)} clip {clip}: every buffer bit "
                f"for bit the plain version's on the CPU (NaN gaps and the "
                f"tensor that is not live untouched): {same}")
            good &= same
    return good


def phase_opt(torch, np, peak, flush, record):
    """The fused AdamW step over llama_350m's 219 parameter shapes, for
    each case of OPT_CASES with and without ClipGradByGlobalNorm(1.0)
    (seeded gradients at 1e-3, a global norm of ~19, so the clip is
    active): three kernel steps against the plain version on the card
    (given the kernel's clip scales; the scale itself within a few f32
    ulps of the plain global norm's) and, on a cut of the tensors,
    against the plain version on the CPU bit for bit; a second run from
    the same state bitwise equal; the poison check; the launches a step.
    Then the kernel, the per-leaf chain and torch._fused_adamw_ (a time
    yardstick the port never calls) timed on the card's clock."""
    from paddle_tpu_torch.nn.clip import _global_scale, _sq_sum
    from paddle_tpu_torch.ops.kernels import multi_tensor_adam as mta
    gen = torch.Generator(device="cuda").manual_seed(11)
    if not opt_poison_check(torch, mta, gen):
        raise SystemExit("opt: the kernel disagrees with its plain version "
                         "on the CPU, or wrote outside its tensors")
    shapes = llama_350m_shapes()
    n_el = sum(int(np.prod(s)) for _, s in shapes)
    wds = [0.0 if "norm" in n else 0.01 for n, _ in shapes]
    cut = [i for i, (_, s) in enumerate(shapes)
           if int(np.prod(s)) <= 3 << 20][::24]
    log(f"opt: llama_350m's {len(shapes)} parameter shapes, {n_el} "
        f"elements; AdamW(lr {OPT_LR}, decay 0.01 off the norms), "
        f"{OPT_STEPS} steps; CPU cut: tensors {cut}")
    worst, rows = 0.0, {}
    for tag, dname, master in OPT_CASES:
        dtype = getattr(torch, dname)
        for clip in (None, 1.0):
            torch.cuda.empty_cache()
            params = [(torch.randn(s, generator=gen, device="cuda") * 0.02)
                      .to(dtype) for _, s in shapes]
            grads = [[(torch.randn(s, generator=gen, device="cuda") * 1e-3)
                      .to(dtype) for _, s in shapes]
                     for _ in range(OPT_STEPS)]
            st = opt_state(torch, params, master)
            plain, again = opt_clone(st), opt_clone(st)
            cpu = [[None if part[i] is None else part[i].cpu()
                    for i in cut] for part in st]
            k0 = mta.multi_tensor_adam.kernel_launches
            infos = opt_run(mta, grads, st, wds, clip)
            torch.cuda.synchronize()
            per_step = (mta.multi_tensor_adam.kernel_launches - k0) \
                / OPT_STEPS
            infos2 = opt_run(mta, grads, again, wds, clip)
            repeat = opt_equal(torch, st, again) and all(
                a is None or torch.equal(a, b) for a, b in zip(infos, infos2))
            del again
            scales = None if clip is None else infos
            opt_run(mta, grads, plain, wds, clip, plain=True, scales=scales)
            err, frac, close = opt_against(torch, st, plain, dtype)
            worst = max(worst, err)
            del plain
            scale_ok = True
            if clip is not None:
                ref_scale, ref_gn = _global_scale(_sq_sum(grads[0]), clip)
                ks, kg = infos[0].tolist()
                scale_ok = ks <= 1.0 and abs(ks - ref_scale.item()) <= \
                    4 * np.spacing(np.float32(ref_scale.item())) and \
                    abs(kg - ref_gn.item()) <= 1e-6 * ref_gn.item()
                log(f"opt {tag} clip: scale {ks!r} (plain {ref_scale.item()!r}"
                    f"), global norm {kg!r} (plain {ref_gn.item()!r}) "
                    f"{scale_ok}")
            cg = [[grads[s][i].cpu() for i in cut] for s in range(OPT_STEPS)]
            opt_run(mta, cg, cpu, [wds[i] for i in cut], clip, plain=True,
                    scales=None if clip is None else
                    [t.cpu() for t in infos])
            on_cpu = opt_equal(torch, [[None if part[i] is None else
                                        part[i].cpu() for i in cut]
                                       for part in st], cpu)
            want_k = mta.kernels_per_step(len(shapes), clip is not None)
            ok = close and repeat and on_cpu and scale_ok \
                and per_step == want_k
            log(f"opt {tag} clip {clip}: against the plain version on the "
                f"card: largest parameter error {err:.3e}, bf16 elements "
                f"an ulp apart {frac:.2e} (rule: Queue 3) {close}; the CPU "
                f"cut bit for bit {on_cpu}; bitwise repeat {repeat}; "
                f"kernels a step {per_step:g} (want {want_k}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"opt {tag} clip {clip}: the kernel "
                                 f"disagrees with its plain version, or "
                                 f"is not repeatable")
            rows[tag, clip] = opt_time(torch, mta, st, grads[0], wds, clip,
                                       master, peak, flush, n_el, tag)
            del st, grads, params, infos
    main = rows["bf16_mp", 1.0]
    record["multi_tensor_adam"].update(
        max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"],
        cases={f"{t}{'' if c is None else '+clip'}": r
               for (t, c), r in rows.items()})
    slow = [k for k, r in rows.items() if r["ms"] >= r["plain_ms"]]
    if slow:
        raise SystemExit(f"opt: the kernel is not faster than the per-leaf "
                         f"chain in {slow}")


def opt_time(torch, mta, st, g, wds, clip, master, peak, flush, n_el, tag):
    """The kernel step and torch._fused_adamw_ over the same tensors (f32
    copies where it refuses the mixed types) on the card's clock
    (``cuda_ms``), the per-leaf chain (the plain version on the card)
    between events (``event_ms``: its launches outnumber the launch
    queue); the bound from opt_bytes at the card's data-sheet rate."""
    kw = dict(lr=OPT_LR, beta1=0.9, beta2=0.999, epsilon=1e-8, step=4,
              decoupled=True)

    cache = {}

    def kern():
        mta.multi_tensor_adam(g, st[0], st[1], st[2], st[3], wds,
                              clip_norm=clip, cache=cache, **kw)

    def plain():
        mta._ref_multi_tensor_adam(g, st[0], st[1], st[2], st[3], wds,
                                   kw["lr"], 0.9, 0.999, 1e-8, 4, True, clip)

    ms = cuda_ms(kern, torch, flush=flush)
    plain_ms = event_ms(plain, torch, flush=flush)
    steps = [torch.zeros((), device="cuda") for _ in st[0]]
    lib_on = "the same tensors"
    lp, lg = st[0], g
    try:
        torch._fused_adamw_(lp, lg, st[1], st[2], [], steps, lr=OPT_LR,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False)
    except RuntimeError as e:
        lib_on = f"f32 copies (it refused the mixed types: {str(e)[:80]})"
        lp = [p.float() for p in st[0]]
        lg = [x.float() for x in g]
    library_ms = cuda_ms(lambda: torch._fused_adamw_(
        lp, lg, st[1], st[2], [], steps, lr=OPT_LR, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), torch,
        flush=flush)
    del lp, lg
    nbytes = n_el * opt_bytes(st[0][0].element_size(), master)
    bound_ms, by = bound(nbytes, 20 * n_el, peak, peak[2])
    log(f"opt {tag} clip {clip} timing: kernel {ms:.4f} ms, per-leaf "
        f"chain {plain_ms:.4f} ms between events ({plain_ms / ms:.1f}x the "
        f"kernel), "
        f"torch._fused_adamw_ {library_ms:.4f} ms on {lib_on} (no clip; it "
        f"decays before the Adam step), bound {bound_ms:.4f} ms ({by}; "
        f"{nbytes} bytes): the kernel at {100 * bound_ms / ms:.0f}% of it")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": by}


def words(torch, t):
    """An integer tensor as int64 (torch's uint32 has copies and views only
    on CUDA: through an int32 view, masked)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def same_bits(torch, a, b):
    """Bit for bit, a NaN matching any NaN at the same place (the card's
    bf16 conversion and torch's spell NaN differently)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(words(torch, a), words(torch, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(na, nb) and torch.equal(a.view(iv)[~na],
                                               b.view(iv)[~nb])


def gumbel_ulps(torch, got, want):
    """Largest distance of ``got`` from ``want`` in f32 ulps of
    ``max(|want|, 1)``."""
    ulp = want.abs().clamp_min(1.0) * 2.0 ** -23
    return ((got.double() - want.double()).abs() / ulp.double()).max().item()


def max_diff(torch, a, b):
    """Largest |a - b| over two outputs of one shape: integers, keys and
    flags as int64 words, floats in f64 with equal values (a NaN against
    a NaN, an Inf against the same Inf) at 0 and a NaN against a number
    at infinity."""
    if a.dtype == torch.bool or not a.dtype.is_floating_point:
        d = (words(torch, a.to(torch.uint8) if a.dtype == torch.bool else a)
             - words(torch, b.to(torch.uint8) if b.dtype == torch.bool
                     else b)).abs()
        return float(d.max().item()) if d.numel() else 0.0
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, 0.0, (a.double() - b.double()).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max().item()) \
        if d.numel() else 0.0


def r1_case(torch, np, gen, S, V, raw_dtype):
    """R1's inputs at [S, V]: filtered logits of scale 3 with a NaN row, an
    Inf row and a row filtered to -1e30 but for a few entries; raw rows
    (``raw_dtype``) equal to them but for a NaN in row 4, which the
    filters erased; random keys; edge and random seeds; mixed fresh and
    emit flags. Flags expected on rows 1, 2 and 4 of the first five
    (below five rows, random rows only)."""
    logits = torch.from_numpy((gen.standard_normal((S, V)) * 3)
                              .astype(np.float32)).cuda()
    edge = S >= 5                   # the planted rows, where there are five
    if edge:
        logits[1, 7] = float("nan")
        logits[2, 3] = float("inf")
        logits[3, 50:] = -1e30
    raw = logits.to(raw_dtype)
    if edge:
        raw[4, 11] = float("nan")
    keys = torch.from_numpy(gen.integers(0, 2**32, (S, 2), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).cuda() \
        .view(torch.uint32)
    seeds = gen.integers(-2**31, 2**31, S, dtype=np.int64).astype(np.int32)
    if edge:
        seeds[:5] = [0, 1, 2**31 - 1, -2**31, -1]
    seeds = torch.from_numpy(seeds).cuda()
    fresh = torch.from_numpy(gen.integers(0, 2, S).astype(np.int32)).cuda()
    emit = torch.from_numpy(gen.integers(0, 2, S).astype(np.int32)).cuda()
    return (logits, keys, seeds, fresh, emit), raw


# Per-element instruction counts of the random kernels' busiest loops:
# name -> (source stem, kernel, template arguments, elements an iteration)
RNG_SASS = {
    "dropout_fwd": ("threefry_fill", "dropout_full_kernel",
                    "__nv_bfloat16,j,0", 8),
    "dropout_vjp": ("threefry_fill", "dropout_full_kernel",
                    "__nv_bfloat16,j,1", 8),
    "keep": ("threefry_fill", "fill_kernel", "0,0,j", 16),
    "gumbel": ("threefry_fill", "fill_kernel", "1,0,j", 4),
    "r1": ("sample_rows", "sample_rows_kernel", "__nv_bfloat16,1", 8),
}
# the parent tree's kernels: one element an iteration
PARENT_SASS = {
    "dropout": ("threefry_fill", "dropout_kernel", "__nv_bfloat16", 1),
    "fill": ("threefry_fill", "fill_kernel", "", 1),
    "r1": ("sample_rows", "sample_rows_kernel", "", 1),
}
RNG_KERNELS = {"threefry_fill": ("dropout_full_kernel", "dropout_kernel",
                                 "fill_kernel"),
               "sample_rows": ("sample_rows_kernel",)}


def import_parent_package(path):
    """The ``paddle_tpu_torch`` of a parent tree unpacked at ``path`` (a
    ``git archive``), imported (once) as the package ``ptt_parent`` beside
    this one; nothing built."""
    import importlib.util
    if "ptt_parent" in sys.modules:
        return sys.modules["ptt_parent"]
    pkg = os.path.join(os.path.abspath(path), "paddle_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "ptt_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ptt_parent"] = mod
    spec.loader.exec_module(mod)
    return mod


def import_parent(path):
    """``import_parent_package(path)``, its build limited to R1's and R2's
    sources: (its sample_rows, its threefry_fill, its _build)."""
    import importlib
    pkg = os.path.join(os.path.abspath(path), "paddle_tpu_torch")
    import_parent_package(path)
    pb = importlib.import_module("ptt_parent.ops.kernels._build")
    pb._sources = lambda: [pb.CSRC / "sample_rows.cu",
                           pb.CSRC / "threefry_fill.cu"]
    t0 = time.perf_counter()
    pb.build_all()
    log(f"rng parent: {pkg} imported as ptt_parent, R1 and R2 built in "
        f"{time.perf_counter() - t0:.1f} s")
    return (importlib.import_module("ptt_parent.ops.kernels.sample_rows"),
            importlib.import_module("ptt_parent.ops.kernels.threefry_fill"),
            pb)


def rng_sass(build, table, tag):
    """{name: instructions an element by class} of ``table``'s kernels in
    the libraries ``build`` (a _build module) made, each logged."""
    out = {}
    for name, (stem, kernel, targs, per) in table.items():
        c = sass_counts(build._target(build.CSRC / f"{stem}.cu"), kernel,
                        targs, per)
        out[name] = c
        log(f"rng sass {tag} {name} ({kernel}<{targs}>, {per} elements an "
            f"iteration of loop {c['loop']}): an element " + ", ".join(
                f"{k} {c[k]:.2f}" for k in INSTR if k in c))
    return out


def ops_of(*terms):
    """bound()'s instruction counts from (elements, counts an element)
    pairs."""
    return {k: sum(n * c.get(k, 0) for n, c in terms) for k in INSTR}


def plus(*counts):
    """Instruction counts added class by class."""
    return {k: sum(c.get(k, 0) for c in counts) for k in INSTR}


# The least instructions an element of each random function needs, counted
# from the function (not from a kernel), for the bounds the records keep.
# One Threefry-2x32 on a 32-bit counter: 20 rotates (SHF) and 21 xors
# (LOP3, the output's included), which only the integer ALU takes, and 27
# adds (20 rounds'; x1's key adds, 1 at the start, 4 between blocks and 1
# at the end, and x0's at the end: x0's other key adds fold into the next
# round's three-input add, its first is the key itself), which the ALU
# (IADD3) or the FMA pipe (IMAD) can take. The keep test is one compare of
# the bits against T << 9; a 16-bit value's conversions are one shift in
# and half an F2FP (two to an instruction) out; the uniform float is a
# shift and an or, then a subtract, a multiply-add and a max; R1 adds the
# logit, compares with the best and tests the raw value. The division and
# the select are not counted (the bound stays a lower bound), and the two
# f64 logs take the kernel's own FP64 count (libdevice's log, which the
# plain version's f64 log on the card also runs). The vjp's one ALU
# instruction a mask element is its saved bit's test.
HASH = {"alu": 41, "flex": 27}
KEEP = {"alu": 1}
CVT16 = {"flex": 1, "fp32": 0.5}
UNIFORM = {"alu": 2, "fp32": 3}
NEED = {"dropout_fwd": plus(HASH, KEEP, CVT16),   # a full mask, 16-bit
        "dropout_vjp": plus(KEEP, CVT16),         # the saved bit's test
        "mask": plus(HASH, KEEP),                 # a mask element
        "value16": CVT16,                         # a value element
        "gumbel": plus(HASH, UNIFORM),
        "r1": plus(HASH, UNIFORM, {"fp32": 3, "flex": 1})}


def need(name, sass):
    """NEED[name], the f64 logs' instructions (gumbel, r1) from the
    kernel's SASS counts ``sass``."""
    if name in ("gumbel", "r1"):
        return plus(NEED[name], {"fp64": sass[name]["fp64"]})
    return NEED[name]


POISON = 0x7FC00000         # an f32 NaN's bits, in every poisoned output word


def r1_planted(torch, np, gen, S, V, chunk, raw_dtype):
    """R1's inputs at [S, V] with planted rows by s % 5 (chunk: the plan's
    chunk c): 0 +inf at c - 1, c and 2c + 3 (a tie across a block
    boundary: c - 1 wins); 1 NaNs at 2c + 1 and 3c + 2 (several chunks:
    2c + 1 wins over every number) and +inf at 5; 2 all -inf (index 0
    wins); 3 1e9 at V - 1 (the last chunk), its raw row NaN at V - 2; 4
    random. Returns (args, raw, {row: expected token})."""
    logits = torch.from_numpy((gen.standard_normal((S, V)) * 3)
                              .astype(np.float32)).cuda()
    raw_extra, want = [], {}
    at = lambda i: min(V - 1, i)                               # noqa: E731
    for s in range(S):
        kind = s % 5
        if kind == 0:
            for i in (chunk - 1, chunk, 2 * chunk + 3):
                logits[s, at(i)] = float("inf")
            want[s] = at(chunk - 1)
        elif kind == 1:
            logits[s, at(5)] = float("inf")
            for i in (3 * chunk + 2, 2 * chunk + 1):
                logits[s, at(i)] = float("nan")
            want[s] = min(at(2 * chunk + 1), at(3 * chunk + 2))
        elif kind == 2:
            logits[s] = float("-inf")
            want[s] = 0
        elif kind == 3:
            logits[s, V - 1] = 1e9
            raw_extra.append((s, max(0, V - 2)))
            want[s] = V - 1
    raw = logits.to(raw_dtype, copy=True)
    for s, i in raw_extra:
        raw[s, i] = float("nan")
    keys = torch.from_numpy(gen.integers(0, 2**32, (S, 2), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).cuda() \
        .view(torch.uint32)
    seeds = torch.from_numpy(gen.integers(-2**31, 2**31, S, dtype=np.int64)
                             .astype(np.int32)).cuda()
    fresh = torch.from_numpy(gen.integers(0, 2, S).astype(np.int32)).cuda()
    emit = torch.from_numpy(gen.integers(0, 2, S).astype(np.int32)).cuda()
    return (logits, keys, seeds, fresh, emit), raw, want


def r1_poisoned(torch, sr, args, raw, alias=False):
    """R1 launched into outputs poisoned with NaN bits (``alias``: keys_out
    is a copy of keys passed as both): (tokens, keys_out, bad)."""
    S = args[0].shape[0]
    dev = args[0].device
    tokens = torch.full((S,), POISON, dtype=torch.int32, device=dev)
    bad = torch.full((S,), POISON, dtype=torch.int32, device=dev)
    if alias:
        keys = args[1].clone()
        sr._launch(args[0], keys, *args[2:], raw, tokens, keys, bad)
        return tokens, keys, bad
    keys_out = torch.full((S, 2), POISON, dtype=torch.int32,
                          device=dev).view(torch.uint32)
    sr._launch(*args, raw, tokens, keys_out, bad)
    return tokens, keys_out, bad


def phase_rng(torch, np, peak, flush, record, parent=None):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import sample_rows as sr
    from paddle_tpu_torch.ops.kernels import threefry_fill as tf
    F = nn.functional
    for stem, names in RNG_KERNELS.items():
        log_ptxas("rng", stem, names)
    sass = rng_sass(_build, RNG_SASS, "new")
    psr = ptf = psass = None
    if parent is not None:
        psr, ptf, pbuild = import_parent(parent)
        for stem in RNG_KERNELS:
            info = pbuild.build_log().get(stem)
            if info is not None:
                log(f"rng parent ptxas {stem}: " + " | ".join(
                    ln.strip() for ln in info["ptxas"].splitlines()
                    if "registers" in ln))
        psass = rng_sass(pbuild, PARENT_SASS, "parent")
    gen = np.random.default_rng(11)
    # R1: 1024 rows at Llama-2's and Llama-3's vocabularies, the raw rows
    # in bf16 (the 7B serve's logits) and in f32
    r1_err = 0.0
    for V, raw_dtype in ((32000, torch.bfloat16), (128256, torch.float32)):
        args, raw = r1_case(torch, np, gen, 1024, V, raw_dtype)
        got = sr.sample_rows(*args, raw=raw)
        again = sr.sample_rows(*args, raw=raw)
        want = sr._ref_sample_rows(*args, raw=raw)
        torch.cuda.synchronize()
        errs = [max_diff(torch, a, b) for a, b in zip(got, want)]
        r1_err = max(r1_err, *errs)
        repeat = all(torch.equal(words(torch, a), words(torch, b))
                     for a, b in zip(got, again))
        greedy = torch.argmax(args[0], -1).to(torch.int32)
        differ = (got[0] != greedy).float().mean().item()
        log(f"rng r1 V={V} raw {raw_dtype}: 1024 rows, largest |kernel - "
            f"plain| of tokens / keys out / non-finite flags {errs}, a "
            f"second launch equal {repeat}, tokens off the greedy argmax in "
            f"{100 * differ:.1f}% of rows, flags {got[2][:5].tolist()}")
        if not (max(errs) == 0 and repeat and differ > 0.5
                and got[2][:5].tolist() == [0, 1, 1, 0, 1]):
            raise SystemExit(f"rng: R1 disagrees with its plain version at "
                             f"V = {V}")
    # R1 over many blocks: planted ties across block boundaries, NaNs in
    # several chunks, the maximum and a raw NaN in the last chunk; each
    # case twice into NaN-poisoned outputs, once more with keys_out
    # aliasing keys, and once on the scalar route (an unaligned view)
    r1_bad = []
    sms = sr.sm_count(0)
    for S, V, raw_dtype in ((1, 32000, torch.bfloat16),
                            (8, 32000, torch.bfloat16),
                            (64, 32000, torch.float16),
                            (1, 128256, torch.float32),
                            (8, 128256, torch.bfloat16),
                            (64, 128256, torch.float32)):
        p = sr.plan(S, V, sms)
        args, raw, planted = r1_planted(torch, np, gen, S, V, p.chunk,
                                        raw_dtype)
        before = dict(sr.sample_rows.route_launches)
        runs = [r1_poisoned(torch, sr, args, raw) for _ in range(2)]
        runs.append(r1_poisoned(torch, sr, args, raw, alias=True))
        big = torch.empty((S, V + 1), device="cuda")
        big[:, 1:] = args[0]
        runs.append(r1_poisoned(torch, sr, (big[:, 1:], *args[1:]), raw))
        want = sr._ref_sample_rows(*args, raw=raw)
        torch.cuda.synchronize()
        routes = {k: sr.sample_rows.route_launches[k] - before[k]
                  for k in before}
        errs = [max(max_diff(torch, a, b) for a, b in zip(run, want))
                for run in runs]
        r1_err = max(r1_err, *errs)
        equal = all(torch.equal(words(torch, a), words(torch, b))
                    for run in runs[1:] for a, b in zip(run, runs[0]))
        tok = runs[0][0].tolist()
        hits = all(tok[s] == t for s, t in planted.items())
        flags = runs[0][2].tolist()
        flagged = all(flags[s] == 1 for s in range(S) if s % 5 in (1, 3))
        ok = max(errs) == 0 and equal and hits and flagged and \
            routes == {"vector": 3, "scalar": 1}
        log(f"rng r1 plan S={S} V={V} raw {raw_dtype}: {p.blocks} blocks a "
            f"row of {p.chunk} ({p.threads} threads); largest |kernel - "
            f"plain| of each run (poisoned, poisoned, keys_out = keys, "
            f"scalar route) {errs}, runs bitwise equal {equal}, planted "
            f"tokens {hits}, planted flags {flagged}, routes {routes}")
        if not ok:
            r1_bad.append((S, V))
    if r1_bad:
        raise SystemExit(f"rng: R1's many-block cases failed {r1_bad}")
    # R2's draws against the plain version on the card
    key = prng.PRNGKey(2024)
    worst_ulps, r2_err, checks = 0.0, 0.0, {}
    for shape in ((8, 1024, 16, 64), (1000, 333), (7,), (7, 1001)):
        for what, lo in ((tf._KEEP, 0.9), (tf._KEEP, 0.5), (tf._KEEP, 0.0),
                         (tf._KEEP, 1.0), (tf._GUMBEL, prng.TINY_F32),
                         (tf._GUMBEL, 1e-10)):
            got = tf.fill(key, shape, what, "cuda", lo)
            again = tf.fill(key, shape, what, "cuda", lo)
            want = tf._ref_fill(key, shape, what, "cuda", lo=lo)
            tag = f"fill {what} {lo:g} {shape}"
            r2_err = max(r2_err, max_diff(torch, got, want))
            if what == tf._GUMBEL:
                u = gumbel_ulps(torch, got, want)
                worst_ulps = max(worst_ulps, u)
                checks[tag] = u <= RNG_ULPS and torch.equal(got, again)
            else:
                checks[tag] = same_bits(torch, got, want) \
                    and same_bits(torch, got, again)
    # dropout at a small shape (one pass of the kernel's grid) and at the
    # path's shapes: llama_350m's attention output and hidden state, full
    # and broadcast masks; forward (its saved bits too) and the vjp from
    # the saved bits
    cases = []
    for dname in ("float32", "bfloat16", "float16"):
        dtype = getattr(torch, dname)
        x = torch.randn((8, 64, 16, 64), dtype=dtype, device="cuda")
        x.view(-1)[5] = float("nan")
        cases += [(dname, x, m, None) for m in ((8, 64, 16, 64), (8, 1, 16, 1),
                                                (1, 64, 1, 64))]
        x = torch.randn((8, 64, 32, 32), dtype=dtype, device="cuda")
        cases.append((dname, x, (8, 64, 1, 1), None))        # dropout2d
        x = torch.randn((7, 1001), dtype=dtype, device="cuda")
        cases += [(dname, x, (7, 1001), None), (dname, x, (7, 1), None)]
        buf = torch.randn((8 * 64 * 16 * 64 + 1,), dtype=dtype,
                          device="cuda")
        xo = buf[1:].view(8, 64, 16, 64)                      # unaligned
        cases += [(dname, xo, (8, 64, 16, 64), "scalar"),
                  (dname, xo, (1, 64, 1, 64), "scalar")]
        cases += [(dname, x, m, "wide") for m in ((7, 1001), (1, 1001))]
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        x = torch.randn((8, 1024, 16, 64), dtype=dtype, device="cuda")
        x.view(-1)[3 * 2**21 + 5] = float("nan")
        cases += [(dname, x, m, None) for m in ((8, 1024, 16, 64),
                                                (8, 1024, 1, 64),
                                                (1, 1024, 16, 64))]
    h = torch.randn((8, 1024, 1024), dtype=torch.bfloat16, device="cuda")
    cases += [("bfloat16", h, (8, 1024, 1024), None),
              ("bfloat16", h, (8, 1, 1024), None)]
    routes_seen = dict.fromkeys(tf.ROUTES, 0)
    for dname, x, mask, forced in cases:
        expect = forced or tf.route(tuple(x.shape), mask, True)
        for p, upscale in ((0.0, True), (0.1, True), (0.5, True),
                           (0.5, False), (1.0, True)):
            keep_p, c, mode = tf._plan_args(x, mask, p, upscale)
            before = dict(tf.dropout.route_launches)
            got, bits = tf._launch(x, key, mask, keep_p, c, mode,
                                   save_mask=True, force_route=forced)
            again, bits2 = tf._launch(x, key, mask, keep_p, c, mode,
                                      save_mask=True, force_route=forced)
            want, wbits = tf._ref_dropout(x, key, mask, p, upscale,
                                          save_mask=True)
            g = torch.randn(x.shape, dtype=x.dtype, device="cuda")
            vjp = tf._launch(g, None, mask, keep_p, c, tf._GRAD_MODE[mode],
                             bits_in=bits, force_route=forced)[0]
            wvjp = tf._ref_dropout_vjp(g, wbits, mask, p, upscale)
            took = {k: tf.dropout.route_launches[k] - before[k]
                    for k in before}
            for k in took:
                routes_seen[k] += took[k]
            r2_err = max(r2_err, max_diff(torch, got, want),
                         max_diff(torch, vjp, wvjp))
            checks[f"dropout {dname} {tuple(x.shape)} mask {mask} p={p} "
                   f"upscale={upscale} route {expect}"] = (
                same_bits(torch, got, want) and same_bits(torch, got, again)
                and torch.equal(bits, wbits) and torch.equal(bits, bits2)
                and same_bits(torch, vjp, wvjp) and took[expect] == 3)
    torch.cuda.synchronize()
    bad = [k for k, v in checks.items() if not v]
    log(f"rng r2: {len(checks)} cases (keep masks, Gumbel noise, dropout "
        f"forward with its saved bits and the vjp from them, f32 / bf16 / "
        f"f16, p in 0, 0.1, 0.5, 1, up to "
        f"8 x 1024 x 1024) against the plain version: {len(checks) - len(bad)}"
        f" pass; launches by route {routes_seen}; largest |kernel - plain| "
        f"{r2_err:.3e}; Gumbel noise within {worst_ulps:.3f} ulps of "
        f"max(|g|, 1) (tolerance {RNG_ULPS})")
    if bad:
        raise SystemExit(f"rng: R2 disagrees with its plain version: {bad}")
    rng_times(torch, np, peak, flush, record, sr, tf, sass, psr, ptf, psass,
              r1_err, r2_err, worst_ulps)
    rng_path(torch, F, tf, trandom, record, r2_err)


def rng_times(torch, np, peak, flush, record, sr, tf, sass, psr, ptf,
              psass, r1_err, r2_err, worst_ulps):
    """R1's and R2's times at the main path's shapes beside their bounds
    (bytes, or the least instructions the function needs over the card's
    rates: NEED; and the kernel's own SASS counts over the same rates),
    the plain versions, the library yardsticks and, given a parent tree,
    the parent's kernels in the same call. Each timed call's outputs are
    then held bit for bit against the plain version's."""
    from paddle_tpu_torch.core import prng
    gen = np.random.default_rng(12)
    key = prng.PRNGKey(2024)
    wrong = []

    def line(tag, ms, nbytes, needs, own, plain_ms=None, library=None,
             parent=None):
        b, by, term = bound(nbytes, 0, peak, instr=needs, term=True)
        sb, _, sterm = bound(nbytes, 0, peak, instr=own, term=True)
        text = (f"rng time {tag}: {ms:.4f} ms; the function's bound {b:.4f} "
                f"ms ({by}: {term}; {nbytes} bytes, instructions " +
                ", ".join(f"{k} {v:.4g}" for k, v in needs.items() if v) +
                f"): {100 * b / ms:.1f}% of it; the kernel's own SASS's "
                f"{sb:.4f} ms ({sterm}): {100 * sb / ms:.1f}% of it")
        if parent is not None:
            pms, pops = parent
            pb, _, pterm = bound(nbytes, 0, peak, instr=pops, term=True)
            text += (f"; parent {pms:.4f} ms ({pms / ms:.2f}x the new), the "
                     f"function's bound {100 * b / pms:.1f}% of it, its own "
                     f"SASS's {pb:.4f} ms ({pterm}): {100 * pb / pms:.1f}%")
        if plain_ms is not None:
            text += f"; plain version {plain_ms:.4f} ms (events)"
        if library is not None:
            text += f"; {library[0]} {library[1]:.4f} ms (a yardstick)"
        log(text)
        return {"ms": ms, "bound_ms": b, "bound_by": by, "bound_term": term,
                "sass_bound_ms": sb, "sass_bound_term": sterm,
                "plain_ms": plain_ms,
                "parent_ms": None if parent is None else parent[0]}

    def timed(tag, fn, same, parent_fn=None):
        """min of two times of ``fn`` (change, parent, change, parent with
        ``parent_fn``), and the parent's; ``same(out)`` then holds the
        timed call's outputs against the plain version."""
        ms = cuda_ms(fn, torch, flush=flush)
        pms = None if parent_fn is None else cuda_ms(parent_fn, torch,
                                                     flush=flush)
        ms2 = cuda_ms(fn, torch, flush=flush)
        if parent_fn is not None:
            pms = min(pms, cuda_ms(parent_fn, torch, flush=flush))
        if not same(fn()):
            wrong.append(tag)
        return min(ms, ms2), pms

    out = {}
    # R1 at one live slot, the serve wave's shape, Llama-3's vocabulary and
    # 1024 rows
    for S, V in ((1, 32000), (8, 32000), (8, 128256), (1024, 32000)):
        args, raw = r1_case(torch, np, gen, S, V, torch.bfloat16)
        want = sr._ref_sample_rows(*args, raw=raw)
        ms, pms = timed(
            f"r1 {S} x {V}", lambda: sr.sample_rows(*args, raw=raw),
            lambda got: all(torch.equal(words(torch, a), words(torch, b))
                            for a, b in zip(got, want)),
            None if psr is None else
            (lambda: psr.sample_rows(*args, raw=raw)))
        plain_ms = event_ms(lambda: sr._ref_sample_rows(*args, raw=raw),
                            torch, iters=3 if S > 8 else 10, flush=flush)
        argmax_ms = cuda_ms(lambda: torch.argmax(args[0], -1), torch,
                            flush=flush)
        nbytes = S * V * (4 + 2) + S * (8 + 4 + 4 + 4) + S * (4 + 8 + 4)
        p = sr.plan(S, V, sr.sm_count(0))
        out[f"r1 {S}x{V}"] = line(
            f"r1 {S} x {V} f32, raw bf16 ({p.blocks} blocks a row of "
            f"{p.threads} threads)", ms, nbytes,
            ops_of((S * V, need("r1", sass))), ops_of((S * V, sass["r1"])),
            plain_ms, ("torch.argmax over the same logits", argmax_ms),
            None if pms is None else (pms, ops_of((S * V, psass["r1"]))))
        out[f"r1 {S}x{V}"]["argmax_ms"] = argmax_ms
    # R2: dropout at llama_350m's attention output, full mask, forward
    # with its saved bits (the autograd path), and the backward from them
    x = torch.randn((8, 1024, 16, 64), dtype=torch.bfloat16, device="cuda")
    g = torch.randn_like(x)
    shape, n = tuple(x.shape), x.numel()
    want, wbits = tf._ref_dropout(x, key, shape, 0.1, True, save_mask=True)
    wvjp = tf._ref_dropout_vjp(g, wbits, shape, 0.1, True)
    lib = cuda_ms(lambda: torch.nn.functional.dropout(x, 0.1, training=True),
                  torch, flush=flush)
    yard = ("torch.nn.functional.dropout (Philox: another mask)", lib)
    ms, pms = timed(
        "r2 forward", lambda: tf.dropout(x, key, shape, 0.1, True,
                                         save_mask=True),
        lambda o: same_bits(torch, o[0], want) and torch.equal(o[1], wbits),
        None if ptf is None else
        (lambda: ptf.dropout(x, key, shape, 0.1, True)))
    plain_ms = event_ms(lambda: tf._ref_dropout(x, key, shape, 0.1, True,
                                                save_mask=True),
                        torch, flush=flush)
    pops = None if psass is None else ops_of((n, psass["dropout"]))
    out["fwd"] = line("r2 dropout forward 8 x 1024 x 16 x 64 bf16, full mask, "
                      "saving its bits", ms, 4 * n + n // 8,
                      ops_of((n, need("dropout_fwd", sass))),
                      ops_of((n, sass["dropout_fwd"])), plain_ms, yard,
                      None if pms is None else (pms, pops))
    out["fwd"]["library_ms"] = lib
    vjp_ms, _ = timed(
        "r2 backward", lambda: tf.dropout_vjp(g, wbits, shape, 0.1, True),
        lambda o: same_bits(torch, o, wvjp))
    out["vjp"] = line("r2 dropout backward from the saved bits", vjp_ms,
                      4 * n + n // 8, ops_of((n, need("dropout_vjp", sass))),
                      ops_of((n, sass["dropout_vjp"])),
                      event_ms(lambda: tf._ref_dropout_vjp(
                          g, wbits, shape, 0.1, True), torch, flush=flush))
    log(f"rng r2 backward {vjp_ms:.4f} ms against the forward {ms:.4f} ms: "
        f"{vjp_ms / ms:.2f}x")
    # R2 over broadcast masks: a hidden state's (8, 1, 1024) mask, and
    # dropout2d's channels
    for tag, xs, mask in (("(8, 1, 1024) mask over 8 x 1024 x 1024",
                           (8, 1024, 1024), (8, 1, 1024)),
                          ("dropout2d (8, 64, 1, 1) over 8 x 64 x 32 x 32",
                           (8, 64, 32, 32), (8, 64, 1, 1))):
        xb = torch.randn(xs, dtype=torch.bfloat16, device="cuda")
        nb, m = xb.numel(), math.prod(mask)
        want, wbits = tf._ref_dropout(xb, key, mask, 0.1, True,
                                      save_mask=True)
        ms, pms = timed(
            f"r2 {tag}", lambda: tf.dropout(xb, key, mask, 0.1, True,
                                            save_mask=True),
            lambda o: same_bits(torch, o[0], want) and torch.equal(o[1],
                                                                   wbits),
            None if ptf is None else
            (lambda: ptf.dropout(xb, key, mask, 0.1, True)))
        plain_ms = event_ms(lambda: tf._ref_dropout(xb, key, mask, 0.1, True,
                                                    save_mask=True),
                            torch, flush=flush)
        lib = cuda_ms(lambda: torch.nn.functional.dropout(
            xb, 0.1, training=True), torch, flush=flush)
        out[tag] = line(f"r2 {tag} bf16, saving its bits", ms,
                        4 * nb + -(-m // 8),
                        ops_of((m, need("mask", sass)),
                               (nb, need("value16", sass))),
                        ops_of((m, sass["dropout_fwd"]),
                               (nb, sass["dropout_vjp"])), plain_ms,
                        ("torch.nn.functional.dropout (full mask)", lib),
                        None if pms is None else
                        (pms, ops_of((nb, psass["dropout"]))))
    # the Gumbel draw at the serve wave's vocabulary
    want = tf._ref_fill(key, (8, 32000), tf._GUMBEL, "cuda",
                        lo=prng.TINY_F32)
    ms, pms = timed("r2 gumbel", lambda: tf.gumbel(key, (8, 32000), "cuda"),
                    lambda o: same_bits(torch, o, want),
                    None if ptf is None else
                    (lambda: ptf.gumbel(key, (8, 32000), "cuda")))
    plain_ms = event_ms(lambda: tf._ref_fill(key, (8, 32000), tf._GUMBEL,
                                             "cuda", lo=prng.TINY_F32),
                        torch, flush=flush)
    out["gumbel"] = line("r2 gumbel 8 x 32000 f32", ms, 4 * 8 * 32000,
                         ops_of((8 * 32000, need("gumbel", sass))),
                         ops_of((8 * 32000, sass["gumbel"])), plain_ms, None,
                         None if pms is None else
                         (pms, ops_of((8 * 32000, psass["fill"]))))
    torch.cuda.synchronize()
    log(f"rng times: every timed call's outputs bit for bit the plain "
        f"version's: {not wrong}")
    if wrong:
        raise SystemExit(f"rng: timed calls disagree with their plain "
                         f"versions: {wrong}")
    r1 = out["r1 8x32000"]
    record["sample_rows"].update(
        max_abs_err=r1_err, ms=r1["ms"], plain_ms=r1["plain_ms"],
        bound_ms=r1["bound_ms"], bound_by=r1["bound_by"],
        bound_term=r1["bound_term"], sass_bound_ms=r1["sass_bound_ms"],
        argmax_ms=r1["argmax_ms"], parent_ms=r1["parent_ms"])
    f = out["fwd"]
    record["threefry_fill"].update(
        max_abs_err=r2_err, ms=f["ms"], plain_ms=f["plain_ms"],
        bound_ms=f["bound_ms"], bound_by=f["bound_by"],
        bound_term=f["bound_term"], sass_bound_ms=f["sass_bound_ms"],
        library_ms=f["library_ms"], parent_ms=f["parent_ms"],
        backward_ms=out["vjp"]["ms"], gumbel_ulps=worst_ulps)


def rng_path(torch, F, tf, trandom, record, r2_err):
    """R2's path through the port's entry points, the counters zeroed
    before and read after, against the plain version under the same
    keys."""
    # R2's path: attention with dropout while training, a hidden state's
    # dropout and a hard gumbel_softmax, through the port's entry points
    q, k, v = (torch.randn((8, 1024, 16, 64), dtype=torch.bfloat16,
                           device="cuda", requires_grad=True)
               for _ in range(3))
    h = torch.randn((8, 1024, 1024), dtype=torch.bfloat16, device="cuda",
                    requires_grad=True)
    lg = torch.randn((8, 32000), device="cuda")
    trandom.seed(0)
    zero_counts()
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                         is_causal=True)
    out.float().square().sum().backward()
    hd = F.dropout(h, p=0.1)
    hd.float().sum().backward()
    y = F.gumbel_softmax(lg, hard=True)
    torch.cuda.synchronize()
    counts = read_counts()
    # the path's outputs against the plain version under the same keys
    trandom.seed(0)
    k_attn, k_h, k_g = (trandom.next_key() for _ in range(3))
    with torch.no_grad():
        attn = F._sdp_composition(q, k, v, None, True)
        path = {
            "attention dropout forward": (out, tf._ref_dropout(
                attn, k_attn, tuple(attn.shape), 0.1, True)),
            "hidden dropout forward": (hd, tf._ref_dropout(
                h, k_h, tuple(h.shape), 0.1, True)),
            "hidden dropout backward": (h.grad, tf._ref_dropout_vjp(
                torch.ones_like(h), tf._ref_dropout(
                    h, k_h, tuple(h.shape), 0.1, True, save_mask=True)[1],
                tuple(h.shape), 0.1, True))}
        g_ref = tf._ref_fill(k_g, tuple(lg.shape), tf._GUMBEL, "cuda",
                             lo=1e-10)
    path_ok = {name: same_bits(torch, a, b) for name, (a, b) in path.items()}
    r2_err = max(r2_err, *(max_diff(torch, a, b) for a, b in path.values()))
    path_ok["gumbel_softmax argmax"] = torch.equal(
        y.argmax(-1), torch.argmax(lg + g_ref, -1))
    dropped = (hd == 0).float().mean().item()
    gates = {
        "4 dropout launches, 1 draw, no other kernel":
            counts["r2_dropout"] == 4 and counts["r2_fill"] == 1
            and not any(n for name, n in counts.items()
                        if name not in ("r2_dropout", "r2_fill")),
        **{f"finite {name}": torch.isfinite(t).all().item()
           for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                           ("dv", v.grad), ("dh", h.grad), ("y", y))},
        "dropped share within 0.01 of p": abs(dropped - 0.1) < 0.01,
        # torch.randn in bf16 on the card can give an exact 0, whose kept
        # output is 0 too: held where h is not 0
        "the gradient zero where a nonzero input's output is": torch.equal(
            (h.grad == 0) & (h != 0), (hd == 0) & (h != 0)),
        "a one-hot gumbel_softmax": (y - y.round()).abs().max().item()
            <= 1e-6 and (y.round().sum(-1) == 1).all().item(),
        **path_ok}
    log(f"rng r2 path: attention dropout (8 x 1024 x 16 x 64 bf16) forward "
        f"and backward, a hidden state's dropout (8 x 1024 x 1024) forward "
        f"and backward and a hard gumbel_softmax (8 x 32000): launches "
        f"{counts}, dropped share {dropped:.4f} (p = 0.1); gates, the last "
        f"four against the plain version under the same keys {gates}")
    bad = [name for name, good in gates.items() if not good]
    if bad:
        raise SystemExit(f"rng: R2's path failed {bad}")
    record["threefry_fill"].update(
        max_abs_err=r2_err,
        launches=counts["r2_dropout"] + counts["r2_fill"])


def serve_wave(srv, prompts, n_new, seeds=None):
    seeds = [None] * len(prompts) if seeds is None else seeds
    rids = [srv.submit(p, max_new_tokens=n_new, seed=s)
            for p, s in zip(prompts, seeds)]
    out = srv.run()
    return [out[r] for r in rids]


def counters():
    """The kernels' launch counters: {name: (wrapper, attribute)}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels.fused_tick import fused_tick_attention
    from paddle_tpu_torch.ops.kernels.gemm_epilogue import gemm_epilogue
    from paddle_tpu_torch.ops.kernels.multi_tensor_adam import \
        multi_tensor_adam
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention
    from paddle_tpu_torch.ops.kernels.quant_matmul import quantized_matmul
    from paddle_tpu_torch.ops.kernels.ragged_prefill import \
        ragged_prefill_attention
    from paddle_tpu_torch.ops.kernels.rope import rope_fwd, rope_qk_fwd
    from paddle_tpu_torch.ops.kernels.sample_rows import sample_rows
    from paddle_tpu_torch.ops.kernels.threefry_fill import dropout, fill
    return {"k1": (paged_attention, "launches"),
            "k2": (ragged_prefill_attention, "launches"),
            "k3": (fused_tick_attention, "launches"),
            "k4_fwd": (fa.flash_fwd, "launches"),
            "k4_dq": (fa.flash_bwd, "dq_launches"),
            "k4_dkv": (fa.flash_bwd, "dkv_launches"),
            "k5_fwd": (rn.rms_norm_fwd, "launches"),
            "k5_bwd": (rn.rms_norm_bwd, "launches"),
            "k6": (rope_fwd, "launches"),
            "k6_qk": (rope_qk_fwd, "launches"),
            "k7": (gemm_epilogue, "launches"),
            "k8": (quantized_matmul, "launches"),
            "opt": (multi_tensor_adam, "launches"),
            "opt_kernels": (multi_tensor_adam, "kernel_launches"),
            "r1": (sample_rows, "launches"),
            "r2_dropout": (dropout, "launches"),
            "r2_fill": (fill, "launches")}


def zero_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def phase_parity(torch, np):
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    cfg = llama_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    rng = np.random.default_rng(5)
    wave1 = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in (1, 7, 8, 13, 17, 30)]
    wave2 = [np.concatenate([wave1[5][:16],
                             rng.integers(0, cfg.vocab_size, (n,))
                             .astype(np.int32)]) for n in (3, 9)]
    outs = {}
    for mode in ("split", "fused"):
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            zero_counts()
            srv = ContinuousBatchingServer(model, max_slots=3,
                                           max_cache_len=64,
                                           cache_backend="paged",
                                           page_size=8,
                                           prefill_tokens_per_tick=5,
                                           serving_mode=mode)
            toks = serve_wave(srv, wave1, 7) + serve_wave(srv, wave2, 7)
            outs[mode, name] = (toks, srv.pool_balance()[1],
                                srv.stats["prefix_auto_hits"], read_counts())
    ref = outs["split", "cpu"][0]
    good = True
    for (mode, name), (toks, live, hits, n) in outs.items():
        same = all(np.array_equal(a, b) for a, b in zip(toks, ref))
        want = {"split": ("k1", "k2"), "fused": ("k3",)}[mode]
        launched = all(n[k] > 0 for k in want) if name == "cuda" \
            else not any(n.values())
        others = not any(v for k, v in n.items() if k not in want)
        log(f"parity {mode} {name}: tokens equal to the CPU split run "
            f"{same}, prefix hits {hits}, live pages {live}, launches {n}")
        good &= same and launched and others and hits > 0 and live == 0
    if not good:
        raise SystemExit("parity: the card and the CPU, or the fused and "
                         "split ticks, disagree")
    # seeded sampling: explicit seeds (edges among them) on the first
    # wave, the default rule (server seed + rid, past 2**31) on the second
    seeds = [0, 2**31 - 1, 2**31, -1, 2**32 - 1, 12345]
    for mode in ("split", "fused"):
        toks = {}
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            zero_counts()
            srv = ContinuousBatchingServer(model, max_slots=3,
                                           max_cache_len=64,
                                           cache_backend="paged",
                                           page_size=8,
                                           prefill_tokens_per_tick=5,
                                           serving_mode=mode,
                                           do_sample=True, temperature=0.8,
                                           top_k=20, top_p=0.9,
                                           seed=2**31 - 4)
            toks[name] = serve_wave(srv, wave1, 7, seeds) + \
                serve_wave(srv, wave2, 7)
            n = read_counts()
            draws = srv.stats["sample_launches"]
            want = {"split": ("k1", "k2"), "fused": ("k3",)}[mode]
            launched = (all(n[k] > 0 for k in want)
                        and n["r1"] == draws > 0) if name == "cuda" \
                else not any(n.values())
            others = not any(v for k, v in n.items()
                             if k not in want + ("r1",))
            live = srv.pool_balance()[1]
            log(f"parity sampled {mode} {name}: {draws} draws, live pages "
                f"{live}, launches {n}")
            good &= launched and others and live == 0
        same = all(np.array_equal(a, b)
                   for a, b in zip(toks["cuda"], toks["cpu"]))
        log(f"parity sampled {mode}: card tokens equal to the CPU's {same}")
        good &= same
    if not good:
        raise SystemExit("parity: seeded sampled tokens of the card and "
                         "the CPU disagree, or R1 was not launched once a "
                         "draw")


def dense_gates(n, L, paged, draws, steps, ragged=None):
    """The launch gates of a dense-path wave on the card: the dense
    backend launches no K1, K2, K3 or R2; the paged pool launches K1
    once a decode step and layer (block steps included), no K3, and K2
    once a layer of each of its ``ragged`` prefill launches (none under
    dense prefill, ``ragged=None``); R1 once a draw; never K6 (serving
    passes position_ids)."""
    checks = {"no k3 or r2 launch":
                  n["k3"] == n["r2_fill"] == n["r2_dropout"] == 0,
              "r1 == the server's draws": n["r1"] == draws,
              "no k6 launch": n["k6"] == n["k6_qk"] == 0}
    if ragged is None:
        checks["no k2 launch"] = n["k2"] == 0
    else:
        checks["k2 == ragged prefill launches x layers"] = \
            n["k2"] == ragged * L > 0
    if paged:
        checks["k1 == decode steps x layers"] = n["k1"] == steps * L > 0
    else:
        checks["no k1 launch"] = n["k1"] == 0
    return checks


def phase_dense_parity(torch, np):
    """The dense paths of a llama_tiny-shaped float32 model on the card
    and on the CPU from the same weights, through the parity phase's two
    waves: equal tokens in every mode, and the launch gates."""
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    cfg = llama_tiny()
    L = cfg.num_layers
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    rng = np.random.default_rng(5)
    wave1 = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in (1, 7, 8, 13, 17, 30)]
    wave2 = [np.concatenate([wave1[5][:16],
                             rng.integers(0, cfg.vocab_size, (n,))
                             .astype(np.int32)]) for n in (3, 9)]
    prefix = wave1[5][:12]              # one 8-token page and a tail
    seeds = [0, 2**31 - 1, 2**31, -1, 2**32 - 1, 12345]
    sample = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
                  seed=2**31 - 4)
    dense = dict(cache_backend="dense")
    paged = dict(cache_backend="paged", page_size=8, prefill_mode="dense")
    # ragged prefill under blocks: slots parked mid-prefill at the
    # max_cache_len sentinel ride K1's block steps past the table
    ragged = dict(cache_backend="paged", page_size=8,
                  prefill_tokens_per_tick=5, tick_block=3)
    modes = [("dense", dense, False), ("dense sampled", dict(dense, **sample),
                                       False),
             ("dense block3", dict(dense, tick_block=3), False),
             ("dense block3 sampled", dict(dense, tick_block=3, **sample),
              False),
             ("paged-dense prefix", paged, True),
             ("paged-dense prefix sampled", dict(paged, **sample), True),
             ("paged-dense prefix block3", dict(paged, tick_block=3), True),
             ("paged-dense prefix block3 sampled",
              dict(paged, tick_block=3, **sample), True),
             ("paged-ragged prefix block3", ragged, True),
             ("paged-ragged prefix block3 sampled", dict(ragged, **sample),
              True)]
    good = True
    for name, kw, register in modes:
        toks = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            srv = ContinuousBatchingServer(model, max_slots=3,
                                           max_cache_len=64, **kw)
            zero_counts()
            toks[dev] = serve_wave(srv, wave1, 7,
                                   seeds if "sampled" in name else None)
            if register:
                srv.register_prefix(prefix)
                srv.register_prefix(prefix)        # a no-op
            toks[dev] += serve_wave(srv, wave2, 7)
            n = read_counts()
            st = srv.stats
            bal = srv.pool_balance()
            if dev == "cuda":
                checks = dense_gates(
                    n, L, kw["cache_backend"] == "paged",
                    st["sample_launches"], st["decode_steps"],
                    None if "prefill_mode" in kw or kw["cache_backend"]
                    == "dense" else st["prefill_launches"])
            else:
                checks = {"no launch on the CPU": not any(n.values())}
            if bal is not None:
                checks["pool drained, the prefix's page pinned"] = \
                    bal[1] == 0 and bal[2] == (1 if register else 0)
            if register:
                checks["prefix hits"] = st["prefix_hit_tokens"] > 0
            checks["no non-finite live logits"] = \
                st["nonfinite_logit_rows"] == 0
            log(f"dense_parity {name} {dev}: {st['decode_ticks']} decode "
                f"ticks ({st['decode_steps']} steps), {st['sample_launches']}"
                f" draws, prefix hit tokens {st['prefix_hit_tokens']}, pool "
                f"{None if bal is None else tuple(bal)}, launches {n}")
            for what, ok in checks.items():
                if not ok:
                    log(f"dense_parity {name} {dev}: check failed: {what}")
                    good = False
        same = all(np.array_equal(a, b)
                   for a, b in zip(toks["cuda"], toks["cpu"]))
        log(f"dense_parity {name}: card tokens equal to the CPU's {same}")
        good &= same
    # generate at B = 3: greedy and one-key sampled, chunked and not
    ids = np.stack([wave1[5], np.concatenate([wave1[4], wave1[3]]),
                    np.concatenate([wave1[3], wave1[4]])]).astype(np.int32)
    n_new = 9
    for sampled in (False, True):
        for chunk in (None, 8):
            kw = dict(max_new_tokens=n_new, prefill_chunk=chunk)
            if sampled:
                kw.update(do_sample=True, seed=2**31 + 5, temperature=0.8,
                          top_k=20, top_p=0.9)
            out = {}
            for dev, model in (("cpu", cpu), ("cuda", gpu)):
                zero_counts()
                out[dev] = model.generate(ids, **kw).cpu().numpy()
                n = read_counts()
                if dev == "cpu":
                    ok = not any(n.values())
                elif sampled:
                    ok = n["r2_fill"] == n_new and not any(
                        v for k, v in n.items() if k != "r2_fill")
                else:
                    ok = not any(n.values())
                tag = f"generate B=3 {'sampled' if sampled else 'greedy'} " \
                      f"chunk {chunk}"
                log(f"dense_parity {tag} {dev}: launches {n}")
                if not ok:
                    log(f"dense_parity {tag} {dev}: check failed: launches "
                        f"(sampled: one r2 fill a draw, {n_new} draws, "
                        f"nothing else; greedy: none)")
                    good = False
            same = np.array_equal(out["cuda"], out["cpu"])
            log(f"dense_parity {tag}: card tokens equal to the CPU's {same}")
            good &= same and out["cuda"].shape == (3, 30 + n_new)
    if not good:
        raise SystemExit("dense_parity: the card and the CPU disagree, or "
                         "a launch gate failed")


def stream_log(np):
    """An ``on_token`` callback and the chunks it receives, by rid."""
    chunks = {}

    def on_token(rid, toks):
        chunks.setdefault(rid, []).append(np.array(toks, copy=True))
    return chunks, on_token


def stream_check(np, chunks, out):
    """The streaming contract across preemption: every ``on_token``
    stream IS its ``wait()`` result — each position delivered once, and
    every chunk a prefix of the result, so a replay neither sends a
    chunk again nor takes a streamed token back. Returns ``(ok,
    [(rid, streamed, result length, differing positions)])`` with a
    request listed where its stream and result disagree."""
    bad = []
    for rid, toks in out.items():
        sent = np.concatenate(chunks[rid]) if chunks.get(rid) \
            else np.zeros((0,), np.int32)
        n = min(len(sent), len(toks))
        diff = [i for i in range(n) if sent[i] != toks[i]]
        if diff or len(sent) != len(toks):
            bad.append((rid, len(sent), len(toks), diff))
    return not bad, bad


def pool_gates(bal, num_pages):
    return {"pool ends live == 0 and preempted == 0":
                bal[1] == 0 and bal.preempted == 0,
            "free + pinned + cached == num_pages - 1":
                bal[0] + bal[2] + bal[3] == num_pages - 1}


PREEMPT_STATS = ("preemptions", "preempt_resumed", "grow_pages",
                 "headroom_pages", "admissions", "prefill_tokens")


def phase_preempt_parity(torch, np):
    """Optimistic admission and preemption of a llama_tiny-shaped float32
    model on the card and on the CPU from the same weights: equal tokens
    and preemption stats, reserve's tokens, drained pools, streams never
    re-sent, and the launch gates."""
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    cfg = llama_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    # tests/test_torch_preemption.py's prompts and pool
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, (int(k),)).astype(np.int32)
               for k in rng.integers(4, 12, (6,))]
    num_pages, n_new = 9, 24
    waves = {"optimistic split": ("optimistic", "split", False),
             "optimistic fused": ("optimistic", "fused", False),
             "optimistic sampled split": ("optimistic", "split", True),
             "reserve split": ("reserve", "split", False)}
    toks, good = {}, True
    for wave, (admission, mode, sample) in waves.items():
        stats = {}
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            kw = dict(do_sample=True, temperature=0.8, top_k=20,
                      top_p=0.9) if sample else {}
            srv = ContinuousBatchingServer(
                model, max_slots=4, max_cache_len=64, cache_backend="paged",
                page_size=8, num_pages=num_pages, admission=admission,
                headroom_pages=1, prefill_tokens_per_tick=6,
                serving_mode=mode, seed=5, **kw)
            chunks, on_token = stream_log(np)
            zero_counts()
            rids = [srv.submit(p, max_new_tokens=n_new, on_token=on_token)
                    for p in prompts]
            out = srv.run()
            n = read_counts()
            toks[wave, name] = [out[r] for r in rids]
            stats[name] = {k: srv.stats[k] for k in PREEMPT_STATS}
            bal = srv.pool_balance()
            want = {"split": ("k1", "k2"), "fused": ("k3",)}[mode]
            draws = srv.stats["sample_launches"]
            if name == "cuda":
                launched = all(n[k] > 0 for k in want) and (
                    n["r1"] == draws > 0 if sample else n["r1"] == 0)
                others = not any(v for k, v in n.items()
                                 if k not in want + ("r1",))
            else:
                launched, others = not any(n.values()), True
            checks = {
                "launches": launched and others,
                "every stream is its result (no chunk re-sent or "
                "taken back)": stream_check(np, chunks, out)[0],
                **pool_gates(bal, num_pages)}
            if admission == "optimistic":
                checks["preempted at least once"] = \
                    srv.stats["preemptions"] >= 1
            log(f"preempt_parity {wave} {name}: stats {stats[name]}, pool "
                f"{tuple(bal)} preempted {bal.preempted}, launches {n}, "
                f"checks {checks}")
            good &= all(checks.values())
        same = all(np.array_equal(a, b) for a, b in
                   zip(toks[wave, "cuda"], toks[wave, "cpu"]))
        log(f"preempt_parity {wave}: card tokens equal to the CPU's {same}, "
            f"stats equal {stats['cuda'] == stats['cpu']}")
        good &= same and stats["cuda"] == stats["cpu"]
    for wave in ("optimistic split", "optimistic fused"):
        same = all(np.array_equal(a, b) for a, b in
                   zip(toks[wave, "cuda"], toks["reserve split", "cuda"]))
        log(f"preempt_parity {wave}: card tokens equal to the reserve "
            f"wave's {same}")
        good &= same
    if not good:
        raise SystemExit("preempt_parity: a gate failed (above)")


def serve_timed(torch, np, srv, prompts, n_new, warm):
    """One wave through ``srv`` tick by tick: a warm-up request first
    (cuBLAS handles, the allocator; its prompt shares no page with the
    wave), then the launch counters zeroed, the wave driven, the counters
    read. Returns the tokens, the counts and the end-to-end metrics."""
    srv.submit(warm, max_new_tokens=2)
    srv.run()
    first_at = {}

    def on_token(rid, toks):
        first_at.setdefault(rid, time.perf_counter())

    zero_counts()
    s0 = dict(srv.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    submitted = {srv.submit(p, max_new_tokens=n_new, on_token=on_token):
                 time.perf_counter() for p in prompts}
    ticks, decode_only_ms = 0, []
    while srv.queue_depth() or srv.in_flight():
        before = srv.stats["prefill_tokens"]
        ts = time.perf_counter()
        srv.step()
        dt = (time.perf_counter() - ts) * 1e3
        ticks += 1
        if srv.stats["prefill_tokens"] == before:
            decode_only_ms.append(dt)
    out = srv.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    d = {k: srv.stats[k] - s0[k] for k in ("decode_ticks", "decode_steps",
                                            "prefill_launches",
                                            "fused_launches",
                                            "fused_passes",
                                            "sample_launches",
                                            "prefix_hit_tokens")}
    pool = srv.pool_balance()
    ttft = sorted((first_at[r] - submitted[r]) * 1e3 for r in submitted)
    decode_only_ms.sort()
    return {"tokens": [out[r] for r in submitted], "counts": counts,
            "ticks": ticks, "wall": wall,
            "tok_s": len(prompts) * n_new / wall,
            "decode_ms": decode_only_ms[len(decode_only_ms) // 2]
            if decode_only_ms else float("nan"),
            "ttft_med": ttft[len(ttft) // 2], "ttft_max": ttft[-1],
            "bad": srv.stats["nonfinite_logit_rows"],
            "pool": None if pool is None else tuple(pool), **d}


def phase_serve(torch, np, card, record):
    import gc
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    cfg = llama2_7b()
    t_init = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    torch.cuda.synchronize()
    log(f"serve: Llama-2-7B bf16 weights from seed 0 in "
        f"{time.perf_counter() - t_init:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    warm = rng.integers(0, cfg.vocab_size, (40,)).astype(np.int32)
    n_new = 32
    L = cfg.num_layers
    log(f"serve: prompts {lens.tolist()}, {n_new} new tokens each")

    def server(mode, sample=False):
        # prefill_tokens_per_tick=512: long prompts stream in as 512-row
        # chunks between (split) or beside (fused) decode rows; sampled
        # waves take a common serving filter
        kw = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95) \
            if sample else {}
        return ContinuousBatchingServer(model, max_slots=8,
                                        max_cache_len=2048, page_size=16,
                                        cache_backend="paged",
                                        prefill_tokens_per_tick=512,
                                        serving_mode=mode, **kw)

    def release():
        # the last server went out of scope: return its pool to the card
        gc.collect()
        torch.cuda.empty_cache()

    # The profiled ticks come after every timed wave and cannot disturb it.
    res = {"split": [], "fused": [], "sampled split": [],
           "sampled fused": []}
    # each wave once: the second, reversed pass that bracketed each wave
    # by its twin (for the host-bound tick's drift) was cut to make room
    # for the moe, moe_parity and host phases; every gate still runs on
    # every wave
    for wave in ("split", "fused", "sampled split", "sampled fused"):
        mode = wave.split()[-1]
        sample = wave.startswith("sampled")
        r = serve_timed(torch, np, server(mode, sample), prompts, n_new,
                        warm)
        release()
        res[wave].append(r)
        c = r["counts"]
        log(f"serve {wave}: {r['ticks']} ticks ({r['decode_ticks']} "
            f"decode, {r['prefill_launches']} prefill launches, "
            f"{r['fused_launches']} fused launches in "
            f"{r['fused_passes']} passes, "
            f"{r['sample_launches']} draws), launches {c}, "
            f"non-finite live logit rows {r['bad']}, pool {r['pool']}")
        log(f"serve metrics {wave} [{card}]: wall {r['wall']:.3f} s, "
            f"{r['tok_s']:.1f} tok/s, median decode-only tick "
            f"{r['decode_ms']:.2f} ms, TTFT median {r['ttft_med']:.1f} ms "
            f"max {r['ttft_max']:.1f} ms")
        if mode == "split":
            launch_checks = {
                "k1 == decode ticks x layers":
                    c["k1"] == r["decode_ticks"] * L > 0,
                "k2 == prefill launches x layers":
                    c["k2"] == r["prefill_launches"] * L > 0,
                "no k3 launch": c["k3"] == 0}
        else:
            launch_checks = {
                "k3 == fused passes x layers":
                    c["k3"] == r["fused_passes"] * L > 0,
                "no k1 or k2 launch": c["k1"] == c["k2"] == 0}
        launch_checks["no k6 launch (rope at position_ids)"] = \
            c["k6"] == c["k6_qk"] == 0
        if not sample:
            launch_checks["no r1 launch"] = c["r1"] == 0
        elif mode == "split":
            # a draw a decode tick, and one a prefill launch that
            # completed a prompt (its first tokens)
            launch_checks["r1 == draws, decode ticks <= r1 <= decode "
                          "ticks + prefill launches"] = \
                c["r1"] == r["sample_launches"] and r["decode_ticks"] \
                <= c["r1"] <= r["decode_ticks"] + r["prefill_launches"]
        else:
            launch_checks["r1 == fused launches (one draw a tick)"] = \
                c["r1"] == r["sample_launches"] == r["fused_launches"]
        launch_checks["no r2 launch"] = c["r2_dropout"] == c["r2_fill"] == 0
        checks = {"32 in-vocabulary tokens each":
                      all(len(t) == n_new and t.min() >= 0
                          and t.max() < cfg.vocab_size for t in r["tokens"]),
                  "no non-finite live logits": r["bad"] == 0,
                  "pool drained (live == 0)": r["pool"][1] == 0,
                  **launch_checks}
        for name, good in checks.items():
            if not good:
                raise SystemExit(f"serve {wave}: check failed: {name}")
    for mode, runs in res.items():
        log(f"serve summary {mode} [{card}]: tok/s "
            f"{[round(r['tok_s'], 1) for r in runs]}, median decode-only "
            f"tick {[round(r['decode_ms'], 2) for r in runs]} ms, TTFT "
            f"median {[round(r['ttft_med'], 1) for r in runs]} ms")
    record["paged_attention"]["launches"] = res["split"][0]["counts"]["k1"]
    record["ragged_prefill"]["launches"] = res["split"][0]["counts"]["k2"]
    record["fused_tick"]["launches"] = res["fused"][0]["counts"]["k3"]
    record["sample_rows"]["launches"] = \
        res["sampled fused"][0]["counts"]["r1"]
    agree = sum(int((a == b).sum()) for a, b in
                zip(res["split"][0]["tokens"], res["fused"][0]["tokens"]))
    log(f"serve: split and fused agree on {agree} of {8 * n_new} tokens "
        f"(informational: bf16 near-ties on random weights may flip)")
    for mode in ("split", "fused"):
        profile_admit(torch, np, server(mode), prompts, warm, card, mode)
        release()
    for mode in ("split", "fused"):
        profile_decode(torch, np, server(mode), cfg, card, mode)
        release()
        profile_decode(torch, np, server(mode, sample=True), cfg, card,
                       f"sampled {mode}")
        release()
    return model, res


def phase_dense(torch, np, card, record, model, serve_res):
    """Llama-2-7B bf16 (the serve phase's model, or a new one from seed
    0) through the dense paths: ``generate`` and the dense and
    dense-prefill servers, timed, with the launch gates of
    ``dense_parity``."""
    import gc
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.ops.kernels import threefry_fill as tf
    cfg = llama2_7b()
    L, V = cfg.num_layers, cfg.vocab_size
    if model is None:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
    sample = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # generate: 4 x 512-token prompts, 64 new tokens
    ids = np.random.default_rng(1).integers(0, V, (4, 512)).astype(np.int32)
    n_new = 64
    gen, gen_counts = {}, {}
    for name, kw in (("greedy", {}), ("sampled", dict(sample, seed=7)),
                     ("greedy chunk256", {"prefill_chunk": 256})):
        model.generate(ids[:1, :64], max_new_tokens=2, **kw)    # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=1, **kw)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        release()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=n_new, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        new = out[:, 512:].cpu().numpy()
        gen[name], gen_counts[name] = new, n
        checks = {"64 in-vocabulary tokens a row":
                      out.shape == (4, 512 + n_new) and new.min() >= 0
                      and new.max() < V,
                  "the prompt returned":
                      np.array_equal(out[:, :512].cpu().numpy(), ids)}
        if "sampled" in name:
            checks["one r2 fill a draw, nothing else"] = \
                n["r2_fill"] == n_new and not any(
                    v for k, v in n.items() if k != "r2_fill")
            # R2 at generate's own shape and keys: the key chain of
            # sample_generate replayed, each draw's [4, V] noise bit for
            # bit against the plain version (after the counted run)
            key, noise_ok = prng.PRNGKey(kw["seed"]), True
            for _ in range(n_new):
                key, sub = prng.split(key)
                noise_ok &= same_bits(
                    torch, tf.gumbel(sub, (4, V), "cuda"),
                    tf._ref_fill(sub, (4, V), tf._GUMBEL, "cuda",
                                 lo=prng.TINY_F32))
            checks[f"r2's [4, {V}] noise equal to its plain version bit "
                   f"for bit, every draw's key"] = noise_ok
            log(f"dense generate {name}: r2's noise at [4, {V}] under "
                f"the {n_new} draws' keys bitwise equal to the plain "
                f"version {noise_ok}")
        else:
            checks["no kernel launch"] = not any(n.values())
        log(f"dense generate {name}: launches {n}")
        log(f"dense generate metrics {name} [{card}]: B=4 x 512 prompt, "
            f"{n_new} new: wall {wall:.3f} s, {4 * n_new / wall:.1f} tok/s, "
            f"TTFT (prefill + first draw) {ttft * 1e3:.1f} ms, TPOT "
            f"{(wall - ttft) / (n_new - 1) * 1e3:.2f} ms, peak memory "
            f"{peak:.2f} GiB")
        for what, ok in checks.items():
            if not ok:
                raise SystemExit(f"dense generate {name}: check failed: "
                                 f"{what}")
        release()
    agree = int((gen["greedy"] == gen["greedy chunk256"]).sum())
    log(f"dense generate: whole and chunked greedy agree on {agree} of "
        f"{4 * n_new} tokens (informational: bf16 products of other "
        f"shapes may flip near-ties)")

    # servers: the serve phase's 8 prompts behind a 256-token prefix
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, size=8)
    stems = [rng.integers(0, V, (int(k),)).astype(np.int32) for k in lens]
    warm = rng.integers(0, V, (40,)).astype(np.int32)
    prefix = np.random.default_rng(2).integers(0, V, (256,)).astype(
        np.int32)
    prompts = [np.concatenate([prefix, p]) for p in stems]
    n_tok = 32
    paged = dict(cache_backend="paged", page_size=16, prefill_mode="dense")
    configs = {"dense": (dict(cache_backend="dense"), False),
               "dense block4": (dict(cache_backend="dense", tick_block=4),
                                False),
               "paged-dense": (paged, True),
               "paged-dense block4": (dict(paged, tick_block=4), True),
               "sampled dense": (dict(cache_backend="dense", **sample),
                                 False),
               "sampled paged-dense": (dict(paged, **sample), True)}
    # each configuration once: the second, reversed pass that bracketed
    # each wave by its twin (for the times' drift) was cut to make room
    # for the moe, moe_parity and host phases; every gate still runs on
    # every configuration
    log(f"dense: prompts {[len(p) for p in prompts]} (a 256-token prefix, "
        f"registered on the paged pool, and the serve phase's prompts), "
        f"{n_tok} new tokens each, 8 slots, max_cache_len 2048")
    res = {name: [] for name in configs}
    for name in configs:
        kw, register = configs[name]
        release()
        torch.cuda.reset_peak_memory_stats()
        srv = ContinuousBatchingServer(model, max_slots=8,
                                       max_cache_len=2048, **kw)
        if register:
            srv.register_prefix(prefix)
        r = serve_timed(torch, np, srv, prompts, n_tok, warm)
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[name].append(r)
        c = r["counts"]
        on_pool = kw["cache_backend"] == "paged"
        steps = max(1, r["decode_steps"] // max(1, r["decode_ticks"]))
        log(f"dense {name}: {r['ticks']} ticks ({r['decode_ticks']} decode, "
            f"{r['decode_steps']} steps, {r['prefill_launches']} prefill "
            f"calls, {r['sample_launches']} draws), prefix hit tokens "
            f"{r['prefix_hit_tokens']}, launches {c}, non-finite live "
            f"logit rows {r['bad']}, pool {r['pool']}")
        log(f"dense metrics {name} [{card}]: wall {r['wall']:.3f} s, "
            f"{r['tok_s']:.1f} tok/s, median decode-only tick "
            f"{r['decode_ms']:.2f} ms ({steps} step{'s' * (steps > 1)}: "
            f"TPOT {r['decode_ms'] / steps:.2f} ms), TTFT median "
            f"{r['ttft_med']:.1f} ms max {r['ttft_max']:.1f} ms, peak "
            f"memory {peak:.2f} GiB")
        checks = {f"{n_tok} in-vocabulary tokens each":
                      all(len(t) == n_tok and t.min() >= 0 and t.max() < V
                          for t in r["tokens"]),
                  "no non-finite live logits": r["bad"] == 0,
                  **dense_gates(c, L, on_pool, r["sample_launches"],
                                r["decode_steps"])}
        if on_pool:
            checks["pool drained, the prefix's 16 pages pinned"] = \
                r["pool"][1] == 0 and r["pool"][2] == 256 // 16
            checks["every prompt hit the prefix"] = \
                r["prefix_hit_tokens"] == 8 * 256
        del srv
        for what, ok in checks.items():
            if not ok:
                raise SystemExit(f"dense {name}: check failed: {what}")
    for name, runs in res.items():
        steps = 4 if "block4" in name else 1
        log(f"dense summary {name} [{card}]: tok/s "
            f"{[round(r['tok_s'], 1) for r in runs]}, TPOT "
            f"{[round(r['decode_ms'] / steps, 2) for r in runs]} ms, TTFT "
            f"median {[round(r['ttft_med'], 1) for r in runs]} ms")
    for a, b in (("dense", "paged-dense"), ("dense", "dense block4"),
                 ("paged-dense", "paged-dense block4")):
        agree = sum(int((x == y).sum()) for x, y in
                    zip(res[a][0]["tokens"], res[b][0]["tokens"]))
        log(f"dense: {a} and {b} agree on {agree} of {8 * n_tok} tokens "
            f"(informational: bf16 near-ties on random weights may flip)")
    if serve_res:
        for mode in ("split", "fused"):
            rs = serve_res.get(mode) or []
            log(f"dense: the serve phase's paged ragged {mode} waves, for "
                f"information [{card}]: tok/s "
                f"{[round(x['tok_s'], 1) for x in rs]}, median decode-only "
                f"tick {[round(x['decode_ms'], 2) for x in rs]} ms, TTFT "
                f"median {[round(x['ttft_med'], 1) for x in rs]} ms max "
                f"{[round(x['ttft_max'], 1) for x in rs]} ms")
    record["paged_attention"]["dense_prefill_launches"] = \
        res["paged-dense"][0]["counts"]["k1"]
    record["sample_rows"]["dense_launches"] = \
        res["sampled dense"][0]["counts"]["r1"]
    record["threefry_fill"]["generate_launches"] = \
        gen_counts["sampled"]["r2_fill"]
    for name in ("dense", "paged-dense"):
        release()
        profile_decode(torch, np, ContinuousBatchingServer(
            model, max_slots=8, max_cache_len=2048, **configs[name][0]),
            cfg, card, name)
    release()
    return model


def preempt_wave(torch, np, srv, prompts, n_new, warm):
    """One wave through the supervised serve thread: a warm-up request
    first (driven by ``run()``), then the counters zeroed, the thread
    started, every request submitted with an ``on_token`` stream and
    collected by ``wait()``, the thread drained and the counters read.
    Each tick's wall time and decoding slots are recorded by wrapping the
    server's tick (measurement only: the wrapper calls it unchanged; the
    serve thread has no public per-tick hook)."""
    srv.submit(warm, max_new_tokens=2)
    srv.run()
    ticks = []
    step = srv._step_locked

    def timed_step():
        before = srv.stats["prefill_tokens"]
        t = time.perf_counter()
        n = step()
        ticks.append(((time.perf_counter() - t) * 1e3, n,
                      srv.stats["prefill_tokens"] != before))
        return n

    srv._step_locked = timed_step
    chunks, stream = stream_log(np)
    first_at = {}

    def on_token(rid, toks):
        first_at.setdefault(rid, time.perf_counter())
        stream(rid, toks)

    zero_counts()
    s0 = dict(srv.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.start()
    submitted = {srv.submit(p, max_new_tokens=n_new, on_token=on_token):
                 time.perf_counter() for p in prompts}
    out = {rid: srv.wait(rid, timeout=900) for rid in submitted}
    wall = time.perf_counter() - t0
    srv.stop(drain=True)
    counts = read_counts()
    d = {k: srv.stats[k] - s0[k]
         for k in ("decode_ticks", "prefill_launches", "fused_launches",
                   "fused_passes",
                   "sample_launches", "preemptions", "preempt_resumed",
                   "grow_pages", "headroom_pages", "nonfinite_logit_rows")}
    ttft = sorted((first_at[r] - submitted[r]) * 1e3 for r in submitted)
    decode_only = sorted(ms for ms, _, prefilled in ticks if not prefilled)
    return {"tokens": [out[r] for r in submitted], "out": out,
            "chunks": chunks, "counts": counts,
            "ticks": len(ticks), "wall": wall,
            "tok_s": len(prompts) * n_new / wall,
            "decode_ms": decode_only[len(decode_only) // 2]
            if decode_only else float("nan"),
            "live": sum(n for _, n, _ in ticks) / max(1, len(ticks)),
            "ttft_med": ttft[len(ttft) // 2], "ttft_max": ttft[-1],
            "retries": srv._sup.retries_total,
            "pool": srv.pool_balance(), **d}


def phase_preempt(torch, np, card, record, model):
    """Optimistic admission on Llama-2-7B bf16 (the serve phase's model,
    or a new one from seed 0) over a pool too small for reserve mode's
    concurrency: reserve split, then optimistic split, fused and sampled
    split waves through the supervised serve loop, timed and gated."""
    import gc
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    cfg = llama2_7b()
    L, V = cfg.num_layers, cfg.vocab_size
    if model is None:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
    rng = np.random.default_rng(15)
    lens = rng.integers(128, 513, size=12)
    prompts = [rng.integers(0, V, (int(n),)).astype(np.int32) for n in lens]
    warm = rng.integers(0, V, (40,)).astype(np.int32)
    n_new, pg = 64, 16
    extents = sorted(-(-(int(n) + n_new) // pg) for n in lens)
    # reserve admission holds at most 4 at once: no 5 full extents fit
    num_pages = sum(extents[:5])          # usable = that sum - 1
    page_bytes = pg * L * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    log(f"preempt: prompts {lens.tolist()}, {n_new} new tokens each; "
        f"full extents {extents} pages; pool {num_pages} pages of {pg} "
        f"tokens ({num_pages * page_bytes / 2**30:.2f} GiB), "
        f"{num_pages - 1} usable < the 5 smallest extents' "
        f"{sum(extents[:5])}: reserve admission holds at most 4 requests")

    def server(admission, mode, sample=False):
        kw = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95) \
            if sample else {}
        return ContinuousBatchingServer(
            model, max_slots=8, max_cache_len=2048, page_size=pg,
            cache_backend="paged", num_pages=num_pages, admission=admission,
            headroom_pages=1, prefill_tokens_per_tick=512,
            serving_mode=mode, **kw)

    res = {}
    for wave in ("reserve split", "optimistic split", "optimistic fused",
                 "optimistic sampled split"):
        words = wave.split()
        admission, mode, sample = words[0], words[-1], "sampled" in words
        r = preempt_wave(torch, np, server(admission, mode, sample),
                         prompts, n_new, warm)
        gc.collect()
        torch.cuda.empty_cache()
        res[wave] = r
        c, bal = r["counts"], r["pool"]
        log(f"preempt {wave}: {r['ticks']} ticks ({r['decode_ticks']} "
            f"decode, {r['prefill_launches']} prefill launches, "
            f"{r['fused_launches']} fused launches in {r['fused_passes']} "
            f"passes, {r['sample_launches']} "
            f"draws), launches k1 {c['k1']} k2 {c['k2']} k3 {c['k3']} r1 "
            f"{c['r1']}, pool {tuple(bal)} preempted {bal.preempted}")
        log(f"preempt metrics {wave} [{card}]: wall {r['wall']:.3f} s, "
            f"{r['tok_s']:.1f} tok/s, median decode-only tick "
            f"{r['decode_ms']:.2f} ms, TTFT median {r['ttft_med']:.1f} ms "
            f"max {r['ttft_max']:.1f} ms, mean decoding slots a tick "
            f"{r['live']:.2f}, preemptions {r['preemptions']}, resumes "
            f"{r['preempt_resumed']}, pages grown {r['grow_pages']}, "
            f"headroom pages {r['headroom_pages']}")
        streamed, disagree = stream_check(np, r["chunks"], r["out"])
        log(f"preempt {wave}: streams that disagree with their result "
            f"(rid, streamed, result length, differing positions): "
            f"{disagree}; {r['preemptions']} preemptions, each replay "
            f"redrew its parked tokens: {streamed}")
        if mode == "split":
            launch_checks = {
                "k1 == decode ticks x layers":
                    c["k1"] == r["decode_ticks"] * L > 0,
                "k2 == prefill launches x layers":
                    c["k2"] == r["prefill_launches"] * L > 0,
                "no k3 launch": c["k3"] == 0}
        else:
            launch_checks = {
                "k3 == fused passes x layers":
                    c["k3"] == r["fused_passes"] * L > 0,
                "no k1 or k2 launch": c["k1"] == c["k2"] == 0}
        launch_checks["r1 == draws" if sample else "no r1 launch"] = \
            c["r1"] == r["sample_launches"] > 0 if sample else c["r1"] == 0
        launch_checks["no k6 or r2 launch"] = \
            c["k6"] == c["k6_qk"] == c["r2_dropout"] == c["r2_fill"] == 0
        checks = {f"{n_new} in-vocabulary tokens each":
                      all(len(t) == n_new and t.min() >= 0
                          and t.max() < V for t in r["tokens"]),
                  "no non-finite live logits":
                      r["nonfinite_logit_rows"] == 0,
                  "no tick failed": r["retries"] == 0,
                  **pool_gates(bal, num_pages), **launch_checks,
                  "every stream is its result (each position sent once, "
                  "no streamed token taken back)": streamed}
        if admission == "optimistic":
            checks["preempted at least once"] = r["preemptions"] >= 1
        for name, good in checks.items():
            if not good:
                raise SystemExit(f"preempt {wave}: check failed: {name}")
    ref = res["reserve split"]["tokens"]
    for wave in ("optimistic split", "optimistic fused"):
        same = sum(int((a == b).sum())
                   for a, b in zip(res[wave]["tokens"], ref))
        log(f"preempt: {wave} and reserve split agree on {same} of "
            f"{len(ref) * n_new} tokens (informational: bf16 near-ties)")
    for key, name in (("paged_attention", "k1"), ("ragged_prefill", "k2")):
        record[key]["preempt_launches"] = \
            res["optimistic split"]["counts"][name]
    record["fused_tick"]["preempt_launches"] = \
        res["optimistic fused"]["counts"]["k3"]
    record["sample_rows"]["preempt_launches"] = \
        res["optimistic sampled split"]["counts"]["r1"]
    return model


# the serving path's attention kernels, by the names the profiler shows
# (K1's and K3's bf16 decode kernels and their merge, K2's and K3's row
# tiles, and the f32 kernels)
ATTENTION_KERNELS = ("paged_decode", "split_merge", "ragged_prefill",
                     "fused_prefill", "fused_rows", "fused_decode")


def profile_admit(torch, np, srv, prompts, warm, card, mode):
    """Where an admission tick's time goes, the tick TTFT waits on: a
    warm-up request served first, then the serve wave's 8 prompts
    submitted and the first tick (admission, a 512-token prefill chunk,
    K2 per layer on a split tick, K3 on a fused one) run under
    torch.profiler: device time by kernel and the attention kernel's
    share. Informational: it checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    srv.submit(warm, max_new_tokens=2)
    srv.run()
    for p in prompts:
        srv.submit(p, max_new_tokens=2)
    before = srv.stats["prefill_tokens"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    chunk = srv.stats["prefill_tokens"] - before
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log("profile admit: the profiler recorded no device time (not "
            "measured)")
    else:
        attn = sum(ms for name, ms, _ in kernels
                   if any(k in name for k in ATTENTION_KERNELS))
        log(f"profile admit {mode} [{card}]: admission tick ({chunk} "
            f"prompt tokens) {wall_ms:.2f} ms wall under the profiler, "
            f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
            f"attention kernel {attn:.3f} ms ({100 * attn / busy:.1f}% of "
            f"device time), {sum(k[2] for k in kernels)} kernel launches")
        for name, ms, count in kernels[:10]:
            log(f"  {ms:8.3f} ms/tick  {count:5d}x  {name[:90]}")
    srv.run()


def profile_decode(torch, np, srv, cfg, card, mode):
    """Where a steady decode tick's time goes: 8 live slots, 5 ticks
    under torch.profiler, device time by kernel, the attention kernels'
    sum and the device's busy share of the wall time. Informational: it
    checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(7)
    admitted = srv.stats["admissions"] + 8
    for _ in range(8):
        srv.submit(rng.integers(0, cfg.vocab_size, (128,)).astype(np.int32),
                   max_new_tokens=24)
    while srv.stats["admissions"] < admitted:
        srv.step()
    srv.step()                           # first all-decode tick: warm
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log("profile: the profiler recorded no device time (not measured)")
    else:
        attn = sum(ms for name, ms, _ in kernels
                   if any(k in name for k in ATTENTION_KERNELS))
        log(f"profile {mode} [{card}]: decode tick {wall_ms:.2f} ms wall, "
            f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
            f"attention kernels {attn:.4f} ms per tick "
            f"({100 * attn / busy:.1f}% of device time), "
            f"{sum(k[2] for k in kernels)} kernel "
            f"launches per tick")
        for name, ms, count in kernels[:10]:
            log(f"  {ms:8.3f} ms/tick  {count:5d}x  {name[:90]}")
    srv.run()


def per_step_counts(L, steps=1, rope=True, opt_kernels=1):
    """The launches a train step of an L-layer Llama makes: K4's three
    kernels once per layer, K5 forward and backward at both norms of
    every layer and the final norm, (unless rope is the composition)
    K6's q + k launch once per layer forward and once backward, and one
    fused optimizer step of ``opt_kernels`` kernels (1 without the clip,
    ``multi_tensor_adam.kernels_per_step``)."""
    return {"k4_fwd": steps * L, "k4_dq": steps * L, "k4_dkv": steps * L,
            "k5_fwd": steps * (2 * L + 1), "k5_bwd": steps * (2 * L + 1),
            "k6": 0, "k6_qk": steps * 2 * L if rope else 0,
            "opt": steps, "opt_kernels": steps * opt_kernels}


@contextlib.contextmanager
def rope_composition():
    """Rope on the composition inside the block (the module-private switch
    of ``ops.rope``), restored after it: the A/B against K6."""
    from paddle_tpu_torch.ops import rope
    old = rope._COMPOSITION_ONLY
    rope._COMPOSITION_ONLY = True
    try:
        yield
    finally:
        rope._COMPOSITION_ONLY = old


def phase_train_parity(torch, np):
    for rope in (True, False):
        train_parity_run(torch, np, rope)


def train_parity_run(torch, np, rope):
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_tiny()
    lr = 1e-3
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=4)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 64))
    want = per_step_counts(cfg.num_layers, rope=rope)
    res = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = torch.as_tensor(ids, device=model.device)
        batch = {"inputs": (t,), "labels": (t,)}
        opt = AdamW(learning_rate=lr, parameters=model.named_parameters())
        step = train_step_fn(model, model.loss, opt)
        with contextlib.nullcontext() if rope else rope_composition():
            # step 1 by hand, to read its gradients; steps 2 and 3
            # through train_step_fn; the counters zeroed before and read
            # after each
            zero_counts()
            loss = model.loss(model(t), t)
            loss.backward()
            grads = {n: p.grad.float().cpu()
                     for n, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses, counts = [loss.item()], [read_counts()]
            for _ in range(2):
                zero_counts()
                losses.append(step(batch).item())
                counts.append(read_counts())
        res[name] = (losses, grads, export_params(model), counts)
    (l_cpu, g_cpu, p_cpu, c_cpu), (l_gpu, g_gpu, p_gpu, c_gpu) = \
        res["cpu"], res["cuda"]
    # f32 on both sides (TF32 off): another summation order in cuBLAS
    # and the kernels; Adam's first steps move a weight by ~lr * sign(g),
    # so trained weights are held to a fiftieth of lr
    loss_err = max(abs(a - b) for a, b in zip(l_cpu, l_gpu))
    grad_ok = all(torch.allclose(g_gpu[n], g_cpu[n], rtol=1e-4, atol=1e-5)
                  for n in g_cpu)
    grad_err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    w_err = max(np.abs(p_gpu[n] - p_cpu[n]).max() for n in p_cpu)
    counted = all({k: c[k] for k in want} == want for c in c_gpu)
    quiet = not any(v for c in c_cpu for v in c.values()) and \
        not any(c[k] for c in c_gpu for k in ("k1", "k2", "k3", "k7", "k8"))
    tag = "K6 rope (q + k)" if rope else "composition rope"
    log(f"train_parity llama_tiny f32, {tag}: losses cpu "
        f"{[round(x, 6) for x in l_cpu]} card {[round(x, 6) for x in l_gpu]}"
        f" (max diff {loss_err:.2e}, tol 1e-5), step-1 gradients max diff "
        f"{grad_err:.2e} (atol 1e-5, rtol 1e-4) {grad_ok}, trained weights "
        f"max diff {w_err:.2e} (tol {0.02 * lr:.0e}), launches per step "
        f"{c_gpu}")
    if not (loss_err <= 1e-5 and grad_ok and w_err <= 0.02 * lr and counted
            and quiet and l_gpu[2] < l_gpu[0]):
        raise SystemExit(f"train_parity ({tag}): the card and the CPU "
                         f"disagree, or a step did not launch each kernel "
                         f"as counted")


def phase_int8_parity(torch, np):
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    from paddle_tpu_torch.ops.kernels.quant_matmul import quantize_tensor
    from paddle_tpu_torch.quantization import to_int8_inference
    cfg = llama_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=8)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    qc, qg = to_int8_inference(cpu), to_int8_inference(gpu)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    zero_counts()
    with torch.no_grad():
        lg = qg(torch.as_tensor(ids, device="cuda"))
        torch.cuda.synchronize()
        counts = read_counts()
        lc = qc(torch.as_tensor(ids))
        h = qc(torch.as_tensor(ids), return_hidden=True)
    # one quantisation step of the head: its input scale x its largest
    # weight scale x 127, what one flipped input code moves a logit by
    _, sx = quantize_tensor(h.reshape(-1, h.shape[-1]))
    step = (sx * qc.lm_head.w_scale.max() * 127).item()
    err = (lg.cpu() - lc).abs().max().item()
    argmax = torch.equal(lg.cpu().argmax(-1), lc.argmax(-1))
    L = cfg.num_layers
    cb = dict(qc.named_buffers())
    held = {n: b for n, b in qg.named_buffers()
            if n.endswith(("qweight_t", "w_scale"))}
    codes = len(held) == 2 * (7 * L + 1) and all(
        torch.equal(b.cpu(), cb[n]) for n, b in held.items())
    launched = counts["k8"] == 7 * L + 1 and counts["k6_qk"] == L \
        and not any(counts[k] for k in ("k1", "k2", "k3", "k6", "k7",
                                        "k4_dq", "k4_dkv", "k5_bwd"))
    log(f"int8_parity llama_tiny f32: int8 codes and scales of every layer "
        f"equal card/CPU {codes}, logits max diff {err:.3e} (tol one quantisation "
        f"step of the head, {step:.3e}), greedy argmax equal {argmax}, "
        f"launches per forward {counts}")
    if not (codes and err <= step and argmax and launched
            and torch.isfinite(lg).all().item()):
        raise SystemExit("int8_parity: the card and the CPU disagree, or a "
                         "forward did not launch K8 7 x layers + 1 times "
                         "and K6's q + k launch once a layer")


# -------------------------------------------------------------- telemetry


def bucket_of(x, bounds):
    """Index of the histogram bucket holding ``x`` (upper bounds
    inclusive, ``len(bounds)`` for +Inf)."""
    for i, b in enumerate(bounds):
        if x <= b:
            return i
    return len(bounds)


def hist_median_bucket(cum):
    """The bucket index of the lower median sample of cumulative bucket
    counts ``cum``."""
    half = cum[-1] / 2
    for i, c in enumerate(cum):
        if c >= half:
            return i
    return len(cum) - 1


def median_in_bucket(lows, highs, cum, bounds):
    """Whether the histogram's median bucket (cumulative counts ``cum``)
    holds the smoke's own median of the same quantity. The smoke reads
    the clock around the server's reads (a submit before and after it, a
    token's tick at its start and at its callback), so each request's
    value lies in [lows[i], highs[i]], and the lower median in the
    buckets from the lows' lower median's to the highs'."""
    k = (len(lows) - 1) // 2
    got = hist_median_bucket(cum)
    return bucket_of(sorted(lows)[k], bounds) <= got \
        <= bucket_of(sorted(highs)[k], bounds)


def telemetry_wave(torch, srv, prompts, n_new, warm, tele=None):
    """``serve_timed``'s wave, tick by tick, with each tick's ledger held
    to the rows its launches ran (the server's ``device_rows``, counted
    from the host arrays it packs; masked page reads: none on the card)
    and each tick's roofline ratio read, when ``tele`` carries the
    server's telemetry objects. Its wall time is the time spent in the
    server's ``submit`` and ``step`` calls, so the readings between ticks
    are not charged to it. Returns serve_timed's metrics and the
    telemetry readings."""
    srv.submit(warm, max_new_tokens=2)
    srv.run()
    first_at, last_at, first_tick, last_tick = {}, {}, {}, {}
    tick_start = [0.0]

    def on_token(rid, toks):
        now = time.perf_counter()
        if rid not in first_at:
            first_at[rid], first_tick[rid] = now, tick_start[0]
        last_at[rid], last_tick[rid] = now, tick_start[0]

    led = cat = None
    if tele is not None:
        led, cat = srv.ledger, srv.costs
        led0, ops0 = led.totals(), cat.totals()
        hists = ("serving_ttft_seconds", "serving_tpot_seconds")
        hist0 = {k: tele.registry.snapshot()[k]["samples"][()]
                 for k in hists}
        n_ev0 = len(srv.recorder.events(kind="tick"))
    zero_counts()
    s0 = dict(srv.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    submitted, around = {}, {}
    for p in prompts:
        before = time.perf_counter()
        rid = srv.submit(p, max_new_tokens=n_new, on_token=on_token)
        submitted[rid] = time.perf_counter()
        around[rid] = (before, submitted[rid])
    wall = time.perf_counter() - t0
    ticks, decode_only_ms = 0, []
    unconserved, rooflines = [], []
    while srv.queue_depth() or srv.in_flight():
        before = srv.stats["prefill_tokens"]
        rows0 = srv.stats["device_rows"]
        n_led = led.ticks if led is not None else 0
        ts = tick_start[0] = time.perf_counter()
        srv.step()
        dt = time.perf_counter() - ts
        wall += dt
        ticks += 1
        if srv.stats["prefill_tokens"] == before:
            decode_only_ms.append(dt * 1e3)
        if led is not None:
            tick = led.snapshot()["last_tick"] if led.ticks > n_led \
                else {}
            rows = srv.stats["device_rows"] - rows0
            if sum(tick.values()) != rows:
                unconserved.append((ticks, dict(tick), rows))
            rooflines.append(cat.snapshot()["roofline_ratio"])
    out = srv.run()
    counts = read_counts()
    d = {k: srv.stats[k] - s0[k] for k in ("decode_ticks", "decode_steps",
                                            "prefill_launches",
                                            "fused_launches",
                                            "fused_passes",
                                            "sample_launches",
                                            "prefill_tokens")}
    pool = srv.pool_balance()
    ttft = sorted((first_at[r] - submitted[r]) for r in submitted)
    tpot = sorted((last_at[r] - first_at[r]) / (n_new - 1)
                  for r in submitted)
    decode_only_ms.sort()
    r = {"tokens": [out[r] for r in submitted], "counts": counts,
         "ticks": ticks, "wall": wall,
         "tok_s": len(prompts) * n_new / wall,
         "decode_ms": decode_only_ms[len(decode_only_ms) // 2]
         if decode_only_ms else float("nan"),
         "ttft_med": ttft[len(ttft) // 2], "tpot_med": tpot[len(tpot) // 2],
         # each request's server-side value lies between these bounds
         "ttft_bounds": ([first_tick[r] - around[r][1] for r in submitted],
                         [first_at[r] - around[r][0] for r in submitted]),
         "tpot_bounds": ([(last_tick[r] - first_at[r]) / (n_new - 1)
                          for r in submitted],
                         [(last_at[r] - first_tick[r]) / (n_new - 1)
                          for r in submitted]),
         "bad": srv.stats["nonfinite_logit_rows"],
         "pool": None if pool is None else tuple(pool), **d}
    if led is not None:
        led1 = led.totals()
        r["ledger"] = {k: led1.get(k, 0) - led0.get(k, 0)
                       for k in set(led1) | set(led0)}
        ops1 = cat.totals()
        r["ops"] = {op: {k: v[k] - ops0.get(op, {}).get(k, 0) for k in v}
                    for op, v in ops1.items()}
        r["unconserved"] = unconserved
        r["rooflines"] = [x for x in rooflines if x is not None]
        r["tick_events"] = srv.recorder.events(kind="tick")[n_ev0:]
        r["hist"] = {}
        for k, snap0 in hist0.items():
            snap1 = tele.registry.snapshot()[k]["samples"][()]
            cum = [c1 - c0 for (_, c1), (_, c0) in zip(snap1["buckets"],
                                                     snap0["buckets"])]
            r["hist"][k] = (snap1["count"] - snap0["count"], cum)
    return r


def phase_telemetry(torch, np, card, peak, record, model, serve_res):
    """The port's telemetry wired into the 7B server (the serve phase's
    model and prompts, or a new model from seed 0): for each mode one
    wave off and one on, and a sampled fused wave on, each gated (tokens
    and launches of the "on" wave equal its mode's "off" wave's; the
    ledger conserves each tick's rows; goodput = prompt rows + decode
    rows; TTFT and TPOT histograms against the smoke's own medians; the
    catalog's roofline ratio <= 1.05 every tick); then ``/metrics`` and
    ``/stats`` scraped from ``serve_metrics`` during a ``start()`` wave,
    a postmortem from an injected prefill fault, and the tracer's spans
    inside a torch.profiler trace."""
    import gc
    import json as _json
    import urllib.request
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import telemetry as tt
    from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                            serve_metrics)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.reliability import FaultInjector
    from paddle_tpu_torch.telemetry.costs import TICK_PHASES
    from paddle_tpu_torch.telemetry.metrics import DEFAULT_BUCKETS
    from paddle_tpu_torch.telemetry.serving import TPOT_BUCKETS
    cfg = llama2_7b()
    L = cfg.num_layers
    if model is None:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
    rng = np.random.default_rng(0)                 # the serve phase's
    lens = rng.integers(128, 1025, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    warm = rng.integers(0, cfg.vocab_size, (40,)).astype(np.int32)
    n_new = 32
    t_phase = time.perf_counter()

    def server(mode, on, sample=False, **extra):
        kw = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95) \
            if sample else {}
        tele = None
        if on:
            tele = tt.ServerTelemetry()
            kw.update(telemetry=tele, recorder=True, ledger=True,
                      journeys=True, costs=tt.CostCatalog(
                          registry=tele.registry, peak_flops=peak[1],
                          peak_hbm_bytes_per_s=peak[0]))
        kw.update(extra)
        return ContinuousBatchingServer(model, max_slots=8,
                                        max_cache_len=2048, page_size=16,
                                        cache_backend="paged",
                                        prefill_tokens_per_tick=512,
                                        serving_mode=mode, **kw), tele

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def gate(wave, srv, tele, r, mode, on, sample, detail):
        """The wave's gates into ``checks``; with ``detail``, its ledger,
        costs and phase split printed too."""
        c = r["counts"]
        log(f"telemetry {wave} [{card}]: {r['ticks']} ticks, "
            f"{r['tok_s']:.1f} tok/s, median decode-only tick "
            f"{r['decode_ms']:.2f} ms, TTFT median {r['ttft_med'] * 1e3:.1f}"
            f" ms, TPOT median {r['tpot_med'] * 1e3:.2f} ms, launches k1 "
            f"{c['k1']} k2 {c['k2']} k3 {c['k3']} r1 {c['r1']}")
        if mode == "split":
            launch = c["k1"] == r["decode_ticks"] * L > 0 and \
                c["k2"] == r["prefill_launches"] * L > 0 and c["k3"] == 0
        else:
            launch = c["k3"] == r["fused_passes"] * L > 0 and \
                c["k1"] == c["k2"] == 0
        launch &= (c["r1"] == r["fused_launches"]) if sample \
            else c["r1"] == 0
        checks[f"{wave}: serve's launch gates"] = launch and \
            c["k6"] == c["k6_qk"] == c["r2_dropout"] == c["r2_fill"] == 0
        checks[f"{wave}: 32 tokens each, finite logits, pool drained"] = \
            all(len(t) == n_new for t in r["tokens"]) and r["bad"] == 0 \
            and r["pool"][1] == 0
        if not on:
            return
        led = r["ledger"]
        want_good = int(sum(lens)) + len(prompts) * (n_new - 1)
        checks[f"{wave}: the ledger conserves every tick's rows"] = \
            not r["unconserved"]
        checks[f"{wave}: goodput == prompt rows + 8 x 31 decode rows "
               f"({want_good})"] = led.get("goodput") == want_good
        checks[f"{wave}: no masked page read charged on the card"] = \
            led.get("skipped_page_dma", 0) == 0
        nt, ht = r["hist"]["serving_ttft_seconds"]
        np_, hp = r["hist"]["serving_tpot_seconds"]
        checks[f"{wave}: TTFT and TPOT histograms count 8 requests"] = \
            nt == np_ == len(prompts)
        checks[f"{wave}: TTFT median in the smoke's own median's bucket"] \
            = median_in_bucket(*r["ttft_bounds"], ht, DEFAULT_BUCKETS)
        checks[f"{wave}: TPOT median in the smoke's own median's bucket"] \
            = median_in_bucket(*r["tpot_bounds"], hp, TPOT_BUCKETS)
        roof = max(r["rooflines"]) if r["rooflines"] else None
        checks[f"{wave}: roofline ratio <= 1.05 on every tick"] = \
            roof is not None and roof <= 1.05
        if not detail:
            return
        log(f"telemetry {wave} ledger [{card}]: {led}, goodput ratio "
            f"{led.get('goodput', 0) / sum(led.values()):.4f}; ticks not "
            f"conserved {r['unconserved'][:3]}")
        decode_tok = tele.registry.get("serving_tokens_total") \
            .labels(kind="decode").value
        cost = srv.device_costs()
        log(f"telemetry {wave} costs [{card}]: roofline ratio max {roof}, "
            f"decode tokens counted {decode_tok}, compiles "
            f"{cost['compiles']}, recompiles {cost['recompiles']}, price "
            f"errors {cost['price_errors']}")
        phases = {}
        for ev in r["tick_events"]:
            for ph, sec in ev.get("phases", {}).items():
                phases[ph] = phases.get(ph, 0.0) + sec
        for op, v in r["ops"].items():
            ph = {"prefill": "prefill_launch", "decode": "decode_launch",
                  "fused": "fused_launch"}.get(op)
            sec = phases.get(ph) if ph else None
            extra = ""
            if sec and v["flops"]:
                mfu = v["flops"] / sec / peak[1]
                ratio = max(mfu, v["hbm_bytes"] / sec / peak[0])
                extra = (f", over its {ph} seconds {sec:.4f}: MFU "
                         f"{mfu:.4f}, roofline {ratio:.4f}")
            log(f"  op {op}: {v['dispatches']} dispatches, "
                f"{v['flops']:.4e} FLOPs, {v['hbm_bytes']:.4e} bytes{extra}")
        ticks_ev = [e for e in r["tick_events"] if "phases" in e]
        admit = ticks_ev[0] if ticks_ev else None
        steady = [e for e in ticks_ev
                  if set(e["dispatches"]) <= {"decode", "fused",
                                              "block_table"}
                  and e["active"] == 8]
        for tag, ev in (("first admission tick", admit),
                        ("a steady decode tick", steady[len(steady) // 2]
                         if steady else None)):
            if ev is not None:
                log(f"  phase split of {tag} (ms): " + ", ".join(
                    f"{p} {ev['phases'][p] * 1e3:.3f}" for p in TICK_PHASES
                    if p in ev["phases"]))

    # each mode's wave without telemetry, then with it; a new server
    # each wave (a server's prefix cache would give a later wave's
    # prompts hits). The cost of telemetry on a tick stays inside the
    # waves' spread at this depth: one pair a mode gates, it does not
    # measure
    checks, res = {}, {}
    for mode in ("split", "fused"):
        for o in ("off", "on"):
            srv, tele = server(mode, o == "on")
            r = telemetry_wave(torch, srv, prompts, n_new, warm, tele)
            waves = res.setdefault(f"{mode} {o}", [])
            waves.append(r)
            gate(f"{mode} {o} {len(waves)}", srv, tele, r, mode, o == "on",
                 False, o == "on" and len(waves) == 1)
            del srv, tele
            release()
        off, on = res[f"{mode} off"], res[f"{mode} on"]
        want = off[0]["tokens"]
        same = min(sum(int((a == b).sum()) for a, b in zip(w["tokens"],
                                                          want))
                   for w in off[1:] + on)
        checks[f"{mode}: the on wave's tokens == the off wave's "
               f"({same} of {len(prompts) * n_new})"] = \
            same == len(prompts) * n_new
        keys = ("k1", "k2", "k3", "r1")
        checks[f"{mode}: the on wave's launches == the off wave's"] = \
            all({k: w["counts"][k] for k in keys}
                == {k: off[0]["counts"][k] for k in keys}
                for w in off[1:] + on)
        log(f"telemetry {mode} on against off [{card}], waves in the order "
            f"off on: tok/s on {on[0]['tok_s']:.1f} off "
            f"{off[0]['tok_s']:.1f}; median decode-only tick on "
            f"{on[0]['decode_ms']:.2f} off {off[0]['decode_ms']:.2f} ms")
    srv, tele = server("fused", True, True)
    r = telemetry_wave(torch, srv, prompts, n_new, warm, tele)
    res["sampled fused on"] = [r]
    gate("sampled fused on", srv, tele, r, "fused", True, True, True)
    del srv, tele
    release()
    if serve_res is not None:
        ref = serve_res["sampled fused"][0]["tokens"]
        same = sum(int((a == b).sum()) for a, b in
                   zip(res["sampled fused on"][0]["tokens"], ref))
        checks[f"sampled fused on tokens == the serve phase's ({same} of "
               f"{len(prompts) * n_new})"] = same == len(prompts) * n_new
    for name, wave, key in (("paged_attention", "split on", "k1"),
                            ("ragged_prefill", "split on", "k2"),
                            ("fused_tick", "fused on", "k3"),
                            ("sample_rows", "sampled fused on", "r1")):
        record[name]["telemetry_launches"] = res[wave][0]["counts"][key]

    # /metrics and /stats from serve_metrics during a start() wave
    srv, tele = server("fused", True)
    ms = serve_metrics(srv)
    try:
        srv.start()
        rids = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
        while srv.stats["admissions"] < len(prompts):
            time.sleep(0.05)
        with urllib.request.urlopen(ms.url + "/metrics", timeout=30) as f:
            page = f.read().decode()
        with urllib.request.urlopen(ms.url + "/stats", timeout=30) as f:
            stats = _json.loads(f.read().decode())
        outs = [srv.wait(r, timeout=300) for r in rids]
        srv.stop(drain=True)
    finally:
        ms.close()
    parsed = tt.parse_prometheus(page)
    checks["/metrics parses, with serving and cost samples"] = \
        any(k[0] == "serving_ttft_seconds_count" for k in parsed) and \
        any(k[0] == "server_flops_total" for k in parsed)
    checks["/stats carries goodput and costs"] = \
        "goodput" in stats["stats"] and "costs" in stats["stats"]
    checks["the start() wave's tokens == the fused on wave's"] = all(
        np.array_equal(a, b) for a, b in zip(outs,
                                             res["fused on"][0]["tokens"]))
    log(f"telemetry exposition: {len(parsed)} samples on /metrics "
        f"({len(page)} bytes), /stats keys {sorted(stats['stats'])[:40]}")
    del srv
    release()

    # a postmortem from a request failed by an injected prefill fault
    fi = FaultInjector(seed=0).on("server.prefill", schedule=[0])
    srv, _ = server("split", True, fault_injector=fi)
    bad = srv.submit(prompts[0], max_new_tokens=4)
    good = srv.submit(prompts[1], max_new_tokens=4)
    out = srv.run()
    pms = srv.postmortems()
    bal = pms[0]["pool_balance"] if pms else {}
    checks["one postmortem from the failed request, its pool balance "
           "adds up"] = \
        len(pms) == 1 and pms[0]["reason"] == "request_failed" and \
        bad in srv.failures and good in out and \
        bal["free"] + bal["live"] + bal["pinned"] + bal["cached"] == \
        srv._kv.num_pages - 1
    log(f"telemetry postmortem: reason {pms[0]['reason'] if pms else None}"
        f", pool balance {bal}, sections {sorted(pms[0]) if pms else []}")
    del srv
    release()

    # the tracer's spans inside a torch.profiler trace: one request's
    # admission tick and its decode tick
    tele = tt.ServerTelemetry(tracer=tt.Tracer(annotate=True))
    srv = ContinuousBatchingServer(model, max_slots=8, max_cache_len=2048,
                                   page_size=16, cache_backend="paged",
                                   telemetry=tele)
    srv.submit(warm, max_new_tokens=2)
    srv.run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv.submit(prompts[2], max_new_tokens=2)
        srv.run()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    spans = {"request.queued", "request.prefill", "request.decode"}
    checks["the server's spans are among the profiler's events"] = \
        spans <= names
    log(f"telemetry trace: spans {sorted(spans & names)} of "
        f"{sorted(spans)} among {len(names)} profiler event names")
    del srv
    release()
    log(f"telemetry: phase {time.perf_counter() - t_phase:.1f} s wall; "
        f"checks {checks}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"telemetry: check failed: {name}")
    return model


def fleet_drive(router, reps, cap=20000):
    """Drive a router's fleet from this thread: one supervisor poll,
    then one ``step()`` of every serving replica with work, until the
    fleet is idle (a killed replica is never stepped). While a handoff
    pump runs (its own thread), each round leaves it a few milliseconds
    to take the servers' locks between ticks. A paused migration or an
    open staging holds a slot, so an idle fleet has none in flight."""
    idle = 0
    for _ in range(cap):
        router.poll()
        busy = False
        for rep in reps:
            if rep.health != "dead" and (rep.queue_depth()
                                         or rep.in_flight()):
                rep.step()
                busy = True
        idle = 0 if busy else idle + 1
        if idle >= 2:
            return
        if router._pumping or not busy:
            time.sleep(0.005 if router._pumping else 0.001)
    raise SystemExit("fleet: the router's drive did not converge")


def fleet_stats(reps, keys=("decode_ticks", "prefill_launches",
                            "fused_passes", "sample_launches")):
    return {k: sum(r.stats[k] for r in reps) for k in keys}


def fleet_launch_gates(c, before, after, L, sample):
    """The launch gates of one fleet wave over its replicas, from the
    counters read just after it (``c``) and the replicas' summed stats
    before and after: K1 == decode ticks x layers and K2 == prefill
    launches x layers over the split replicas, K3 == fused passes x
    layers over the fused ones, R1 == the draws (none when greedy)."""
    d = {k: after[k] - before[k] for k in after}
    gates = {"k1 == decode ticks x layers": c["k1"] == d["decode_ticks"] * L,
             "k2 == prefill launches x layers":
                 c["k2"] == d["prefill_launches"] * L,
             "k3 == fused passes x layers": c["k3"] == d["fused_passes"] * L,
             "k1 + k3 > 0 (the wave ran on the kernels)":
                 c["k1"] + c["k3"] > 0,
             "r1 == draws": c["r1"] == d["sample_launches"]
             and (c["r1"] > 0) == bool(sample),
             "no k6 or r2 launch":
                 c["k6"] == c["k6_qk"] == c["r2_dropout"] == c["r2_fill"]
                 == 0}
    return d, gates


def fleet_check(tag, checks):
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"{tag}: check failed: {name}")


def fleet_parity_run(np, model):
    """One pass of the fleet_parity scripts on ``model`` (llama_tiny in
    f32); returns {scenario: tokens} and {scenario: launch counts}."""
    from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                            ReplicaRouter)
    V = model.cfg.vocab_size
    rng = np.random.default_rng(8)
    p_mig = rng.integers(0, V, (37,)).astype(np.int32)
    kw = dict(max_slots=2, max_cache_len=64, cache_backend="paged",
              page_size=8, prefill_tokens_per_tick=16)
    sample = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    toks, counts = {}, {}
    # mid-decode migration, split and fused, greedy and sampled: never
    # migrated, then moved after 5 tokens
    for mode in ("split", "fused"):
        for s in (False, True):
            k = dict(kw, serving_mode=mode, **(sample if s else {}))
            zero_counts()
            ref = serve_wave(ContinuousBatchingServer(model, **k), [p_mig],
                             16, [9])[0]
            src = ContinuousBatchingServer(model, **k)
            tgt = ContinuousBatchingServer(model, **k)
            rid = src.submit(p_mig, max_new_tokens=16, seed=9)
            while src._slots[0] is None or len(src._slots[0].emitted) < 5:
                src.step()
            state, payloads = src.migrate_out(rid)
            new = tgt.migrate_in(state, payloads)   # verifies every sha256
            src.migrate_finish(rid)
            out = tgt.run()[new]
            name = f"migrate {mode} {'sampled' if s else 'greedy'}"
            toks[name] = (ref, out)
            counts[name] = read_counts()
            fleet_check(f"fleet_parity {name}", {
                "tokens equal the never-migrated run's":
                    np.array_equal(ref, out),
                "zero re-prefill on the target":
                    tgt.stats["prefill_tokens"] == 0,
                "live == 0 on both": src.pool_balance()[1]
                == tgt.pool_balance()[1] == 0})
    # spill then restore: session A spilled by three later sessions,
    # then its next turn restores it
    prompts = [rng.integers(0, V, (16,)).astype(np.int32) for _ in range(4)]
    ext = rng.integers(0, V, (3,)).astype(np.int32)
    zero_counts()
    outs = {}
    for name, extra in (("oracle", dict(num_pages=24)),
                        ("tiered", dict(num_pages=7, host_tier=True))):
        srv = ContinuousBatchingServer(
            model, **dict(kw, max_slots=1, **extra))
        seq = [serve_wave(srv, [p], 4, [101 + i])[0]
               for i, p in enumerate(prompts)]
        hist = np.concatenate([prompts[0], seq[0].astype(np.int32), ext])
        seq.append(serve_wave(srv, [hist], 4, [105])[0])
        outs[name] = (seq, srv)
    tier = outs["tiered"][1].host_tier
    toks["host tier"] = (outs["oracle"][0], outs["tiered"][0])
    counts["host tier"] = read_counts()
    fleet_check("fleet_parity host tier", {
        "tokens equal the never-evicted run's":
            all(np.array_equal(a, b) for a, b in zip(*toks["host tier"])),
        "spilled and restored": tier.spilled_pages_total > 0
        and tier.restored_pages_total >= 2 and tier.restore_corrupt_total
        == 0})
    # a disaggregated handoff: prefill specialist -> decode replica
    long_p = rng.integers(0, V, (40,)).astype(np.int32)
    zero_counts()
    ref = serve_wave(ContinuousBatchingServer(model, **kw), [long_p], 8,
                     [3])[0]
    pre = ContinuousBatchingServer(model, role="prefill", **kw)
    dec = ContinuousBatchingServer(model, role="decode", **kw)
    router = ReplicaRouter([pre, dec], placement="disaggregated",
                           disagg_prefill_min_tokens=16)
    rid = router.submit(long_p, max_new_tokens=8, seed=3)
    fleet_drive(router, [pre, dec])
    out = router.wait(rid, timeout=60)
    toks["handoff"] = (ref, out)
    counts["handoff"] = read_counts()
    fleet_check("fleet_parity handoff", {
        "tokens equal a single replica's": np.array_equal(ref, out),
        "handed off": router.stats["handoffs"] == 1,
        "zero re-prefill on the decode replica":
            dec.stats["prefill_tokens"] == 0})
    # a kill with failover: three queued requests move to the sibling,
    # the two in flight flush their partials
    zero_counts()
    reps = [ContinuousBatchingServer(model, **kw) for _ in range(2)]
    router = ReplicaRouter(reps)
    wave = [rng.integers(0, V, (n,)).astype(np.int32)
            for n in (9, 12, 20, 7, 15)]
    ref = serve_wave(ContinuousBatchingServer(model, **kw), wave, 6,
                     list(range(5)))
    rids = [router.submit(p, max_new_tokens=6, seed=i)
            for i, p in enumerate(wave)]
    # least-loaded spreads the wave: kill the replica holding more
    victim = max(range(2), key=lambda i: reps[i].queue_depth()
                 + reps[i].in_flight())
    for _ in range(3):
        reps[victim].step()
    reps[victim].kill()
    fleet_drive(router, reps)
    got = [router.wait(r, timeout=60) for r in rids]
    toks["failover"] = (ref, got)
    counts["failover"] = read_counts()
    fleet_check("fleet_parity failover", {
        "each result a prefix of (or equal to) the never-killed run's":
            all(np.array_equal(g, r[:len(g)]) for g, r in zip(got, ref)),
        "no request failed": router.failures == {},
        "live == 0 on every replica, the corpse too":
            all(r.pool_balance()[1] == 0 for r in reps)})
    return toks, counts


def phase_fleet_parity(torch, np):
    """llama_tiny in f32 on the card against the same scripts on the
    CPU: a mid-decode migration (split and fused, greedy and sampled),
    a spill then restore through the host tier, a disaggregated handoff
    through the router and a kill with failover. Every page's sha256 is
    checked on arrival (``migrate_in``)."""
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    cfg = llama_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    t0 = time.perf_counter()
    cpu_toks, cpu_counts = fleet_parity_run(np, cpu)
    card_toks, card_counts = fleet_parity_run(np, gpu)
    def flat(runs):     # (reference, result), each tokens or a list
        return [t for r in runs for t in (r if isinstance(r, list)
                                          else [r])]

    good = True
    for name in cpu_toks:
        a, b = flat(card_toks[name]), flat(cpu_toks[name])
        same = len(a) == len(b) and all(
            np.array_equal(x, y) for x, y in zip(a, b))
        n = card_counts[name]
        split = "fused" not in name
        want = ("k3",) if not split else ("k1", "k2")
        launched = all(n[k] > 0 for k in want)
        if "sampled" in name:
            launched &= n["r1"] > 0
        idle_cpu = not any(cpu_counts[name].values())
        log(f"fleet_parity {name}: card tokens equal to the CPU's {same}, "
            f"card launches {n}")
        good &= same and launched and idle_cpu
    log(f"fleet_parity: {time.perf_counter() - t0:.1f} s")
    if not good:
        raise SystemExit("fleet_parity: the card's fleet tokens differ from "
                         "the CPU's, or a kernel of the path was not "
                         "launched")


def fleet_migration(torch, np, model, kw, prompt, n_new, mode, sample):
    """One request moved A -> B mid-decode between two identical
    replicas, against its never-migrated run on a third; returns the
    timings and the gates' inputs. The server's own ``migrate_out`` /
    ``migrate_in`` move the pages; their parts (gather, host copy, hash,
    scatter) are timed again on the same pages right after."""
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.inference.kv_tier import _sha256
    k = dict(kw, serving_mode=mode)
    if sample:
        k.update(do_sample=True, temperature=0.8, top_k=50, top_p=0.95)
    sync = torch.cuda.synchronize
    ref_srv = ContinuousBatchingServer(model, **k)
    ref = serve_wave(ref_srv, [prompt], n_new, [11])[0]
    del ref_srv
    src = ContinuousBatchingServer(model, **k)
    tgt = ContinuousBatchingServer(model, **k)
    s_src, s_tgt = fleet_stats([src]), fleet_stats([tgt])
    zero_counts()
    rid = src.submit(prompt, max_new_tokens=n_new, seed=11)
    while src._slots[0] is None or len(src._slots[0].emitted) < 8:
        src.step()
    sync()
    t0 = time.perf_counter()
    state, payloads = src.migrate_out(rid)
    t_out = time.perf_counter() - t0
    t0 = time.perf_counter()
    new = tgt.migrate_in(state, payloads)
    sync()
    t_in = time.perf_counter() - t0
    src.migrate_finish(rid)
    pages = tgt._kv.slot_pages(0)[:len(payloads)]
    # the parts, on the target's pages (they hold the payloads now, and
    # the target has not decoded into the last one yet)
    pool = tgt._caches["pool"]
    idx = torch.tensor(pages, dtype=torch.long, device="cuda")
    sync()
    t0 = time.perf_counter()
    dev = [pool[n].transpose(0, 1)[idx] for n in ("k", "v")]
    sync()
    t_gather = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [d.view(torch.uint16).cpu().numpy() for d in dev]
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    digests = [_sha256([host[0][j], host[1][j]]) for j in range(len(pages))]
    t_hash = time.perf_counter() - t0
    t0 = time.perf_counter()
    tgt._scatter_pages(pages, payloads)
    sync()
    t_scatter = time.perf_counter() - t0
    out = tgt.run()[new]
    counts = read_counts()
    launch = fleet_stats([src, tgt])
    before = {key: s_src[key] + s_tgt[key] for key in s_src}
    nbytes = sum(a.nbytes for p in payloads for a in p)
    return {"ref": ref, "out": out, "counts": counts, "before": before,
            "after": launch, "pages": len(payloads), "bytes": nbytes,
            "out_ms": t_out * 1e3, "in_ms": t_in * 1e3,
            "gather_ms": t_gather * 1e3, "copy_ms": t_copy * 1e3,
            "hash_ms": t_hash * 1e3, "scatter_ms": t_scatter * 1e3,
            "digests_equal": digests == state["sha256"],
            "tgt_prefill": tgt.stats["prefill_tokens"],
            "tgt_admissions": tgt.stats["admissions"],
            "live": (src.pool_balance()[1], tgt.pool_balance()[1])}


def phase_fleet(torch, np, card, model):
    """The in-process fleet on Llama-2-7B in bf16 (the serve phase's
    model, or a new one from seed 0): paged ragged replicas sharing the
    model's weights, each with the serve geometry (8 slots x 2048
    tokens, 16-token pages, 512 prompt tokens a tick), behind the port's
    ``ReplicaRouter``."""
    import gc
    import json as _json
    import urllib.error
    import urllib.request
    from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                            ReplicaRouter, serve_metrics)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    cfg = llama2_7b()
    L, V = cfg.num_layers, cfg.vocab_size
    if model is None:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
    kw = dict(max_slots=8, max_cache_len=2048, page_size=16,
              cache_backend="paged", prefill_tokens_per_tick=512)
    mib = 2**20

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    release()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, size=8)
    stems = [rng.integers(0, V, (int(n),)).astype(np.int32) for n in lens]
    prefix = np.random.default_rng(2).integers(0, V, (256,)).astype(
        np.int32)
    shared = [np.concatenate([prefix, p]) for p in stems]
    n_new = 32
    log(f"fleet [{card}]: Llama-2-7B bf16 replicas sharing one model's "
        f"weights, 8 slots x 2048 tokens, 16-token pages, 512 prompt "
        f"tokens a tick; prompts {[len(p) for p in shared]} behind a "
        f"256-token prefix, {n_new} new tokens")

    # ---- affinity: a donor, then every shared-prefix request follows it
    reps = [ContinuousBatchingServer(model, **kw) for _ in range(3)]
    router = ReplicaRouter(reps, telemetry=True)
    ms = serve_metrics(router)
    health0 = urllib.request.urlopen(ms.url + "/healthz", timeout=10).status
    donor = router.submit(shared[0], max_new_tokens=8, seed=1)
    fleet_drive(router, reps)
    router.wait(donor, timeout=120)
    home = max(range(3), key=lambda i: router.stats["routed"][i])
    before = fleet_stats(reps)
    zero_counts()
    t0 = time.perf_counter()
    sub_ms = []
    rids = []
    for i, p in enumerate(shared[1:]):
        ts = time.perf_counter()
        rids.append(router.submit(p, max_new_tokens=n_new, seed=20 + i))
        sub_ms.append((time.perf_counter() - ts) * 1e3)
    fleet_drive(router, reps)
    outs = [router.wait(r, timeout=300) for r in rids]
    wall = time.perf_counter() - t0
    c = read_counts()
    d, gates = fleet_launch_gates(c, before, fleet_stats(reps), L, False)
    st = router.stats
    hit_tokens = reps[home].stats["prefix_hit_tokens"]
    log(f"fleet affinity [{card}]: donor on replica {home}; routed "
        f"{st['routed']}, affinity hits {st['affinity_hits']}, fallbacks "
        f"{st['fallbacks']}, prefix hit tokens on the donor's replica "
        f"{hit_tokens}; router host ms a submit median "
        f"{sorted(sub_ms)[len(sub_ms) // 2]:.3f} max {max(sub_ms):.3f}; "
        f"{len(outs) * n_new / wall:.1f} tok/s over {wall:.3f} s; "
        f"launches {c}")
    fleet_check("fleet affinity", {
        "every shared-prefix request routed to the donor's replica":
            st["routed"][home] == 8 and st["affinity_hits"] == 7,
        "prefix hit tokens > 0": hit_tokens >= 7 * 256,
        "32 in-vocabulary tokens each": all(
            len(o) == n_new and o.min() >= 0 and o.max() < V
            for o in outs),
        **gates})

    # ---- failover: the donor's replica holds queued and mid-decode work
    before = fleet_stats(reps)
    zero_counts()
    wave = [np.concatenate([prefix, rng.integers(0, V, (int(n),)).astype(
        np.int32)]) for n in rng.integers(64, 400, size=12)]
    rids = [router.submit(p, max_new_tokens=n_new, seed=40 + i)
            for i, p in enumerate(wave)]
    victim = reps[home]
    for _ in range(40):          # until a slot decodes, the queue still held
        victim.step()
        if any(s is not None and s.emitted for s in victim._slots):
            break
    queued_on_victim = victim.queue_depth()
    mid = sum(1 for s in victim._slots if s is not None and s.emitted)
    victim.kill()
    fleet_drive(router, reps)
    outs = [router.wait(r, timeout=300) for r in rids]
    c = read_counts()
    d, gates = fleet_launch_gates(c, before, fleet_stats(reps), L, False)
    st = router.stats
    bal = [tuple(r.pool_balance()) for r in reps]
    full = sum(1 for o in outs if len(o) == n_new)
    log(f"fleet failover [{card}]: killed replica {home} with "
        f"{queued_on_victim} queued and {mid} in flight; requeued "
        f"{st['requeued']}, evacuations {st['evacuations']}, replica lost "
        f"{st['replica_lost']}; {full} of 12 requests complete, partial "
        f"lengths {[len(o) for o in outs if len(o) < n_new]}; pools {bal}; "
        f"launches {c}")
    fleet_check("fleet failover", {
        "the victim held queued and mid-decode work":
            queued_on_victim > 0 and mid > 0,
        "queued requests completed on siblings":
            st["requeued"] >= queued_on_victim and full >= queued_on_victim,
        "no request failed": router.failures == {}
        and st["replica_lost"] == 0,
        "live == 0 on every replica, the corpse too":
            all(b[1] == 0 for b in bal),
        **gates})
    router.stop(drain=False)
    health1 = None
    try:
        urllib.request.urlopen(ms.url + "/healthz", timeout=10)
    except urllib.error.HTTPError as e:
        health1 = e.code
    fleet_snapshot = _json.loads(urllib.request.urlopen(
        ms.url + "/stats", timeout=10).read().decode())["stats"]
    ms.close()
    log(f"fleet serve_metrics(router): /healthz {health0} -> {health1} "
        f"after stop(); /stats routed {fleet_snapshot['routed']}")
    fleet_check("fleet serve_metrics", {
        "/healthz 200 then 503": health0 == 200 and health1 == 503})
    del router, reps, victim
    release()

    # ---- live migration A -> B, split and fused, greedy and sampled
    mig_prompt = np.random.default_rng(3).integers(0, V, (900,)).astype(
        np.int32)
    for mode in ("split", "fused"):
        for sample in (False, True):
            tag = f"{'sampled ' if sample else ''}{mode}"
            r = fleet_migration(torch, np, model, kw, mig_prompt, 24, mode,
                                sample)
            release()
            d, gates = fleet_launch_gates(r["counts"], r["before"],
                                          r["after"], L, sample)
            gb = r["bytes"] / 1e9
            log(f"fleet migration {tag} [{card}]: {r['pages']} pages, "
                f"{r['bytes'] / mib:.1f} MiB; migrate_out "
                f"{r['out_ms']:.2f} ms, migrate_in {r['in_ms']:.2f} ms; "
                f"parts: gather {r['gather_ms']:.2f} ms "
                f"({gb / (r['gather_ms'] / 1e3):.1f} GB/s), host copy "
                f"{r['copy_ms']:.2f} ms "
                f"({gb / (r['copy_ms'] / 1e3):.2f} GB/s), sha256 "
                f"{r['hash_ms']:.2f} ms "
                f"({gb / (r['hash_ms'] / 1e3):.2f} GB/s), scatter "
                f"{r['scatter_ms']:.2f} ms "
                f"({gb / (r['scatter_ms'] / 1e3):.2f} GB/s); end to end "
                f"{gb / ((r['out_ms'] + r['in_ms']) / 1e3):.2f} GB/s; "
                f"launches {r['counts']}")
            fleet_check(f"fleet migration {tag}", {
                "the stream equals the never-migrated run's tokens":
                    np.array_equal(r["out"], r["ref"]),
                "the target prefilled 0 tokens":
                    r["tgt_prefill"] == 0 and r["tgt_admissions"] == 0,
                "every page passed its sha256": r["digests_equal"],
                "live == 0 on both": r["live"] == (0, 0),
                **gates})

    # ---- host tier: a pool sized so that the prefix spills
    tier_p = [np.random.default_rng(30 + i).integers(0, V, (1000,)).astype(
        np.int32) for i in range(3)]
    outs, srvs, spans = {}, {}, {"spill": [], "restore": []}
    for name, extra in (("oracle", {}),
                        ("tiered", dict(num_pages=130, host_tier=True))):
        srv = ContinuousBatchingServer(model, **dict(kw, **extra))
        if name == "tiered":
            reclaim, restore = srv._kv.reclaimer, srv._restore_match

            def timed_reclaim(n, _f=reclaim):
                t = time.perf_counter()
                got = _f(n)
                torch.cuda.synchronize()
                spans["spill"].append(time.perf_counter() - t)
                return got

            def timed_restore(m, _f=restore):
                t = time.perf_counter()
                got = _f(m)
                torch.cuda.synchronize()
                spans["restore"].append(time.perf_counter() - t)
                return got

            srv._kv.reclaimer = timed_reclaim
            srv._restore_match = timed_restore
            zero_counts()
            before = fleet_stats([srv])
        seq = [serve_wave(srv, [p], 16, [60 + i])[0]
               for i, p in enumerate(tier_p)]
        hist = np.concatenate([tier_p[0], seq[0].astype(np.int32),
                               np.asarray([17, 23, 5], np.int32)])
        seq.append(serve_wave(srv, [hist], 16, [63])[0])
        outs[name], srvs[name] = seq, srv
        if name == "tiered":
            c = read_counts()
            d, gates = fleet_launch_gates(c, before, fleet_stats([srv]), L,
                                          False)
    tier = srvs["tiered"].host_tier
    pg_bytes = srvs["tiered"]._row_nbytes() * 16
    sp_b = tier.spilled_pages_total * pg_bytes
    rs_b = tier.restored_pages_total * pg_bytes
    sp_s, rs_s = sum(spans["spill"]), sum(spans["restore"])
    log(f"fleet host tier [{card}]: 130-page pool, spilled "
        f"{tier.spilled_pages_total} pages ({sp_b / mib:.1f} MiB) in "
        f"{sp_s * 1e3:.1f} ms ({sp_b / 1e9 / max(sp_s, 1e-9):.2f} GB/s), "
        f"restored {tier.restored_pages_total} pages ({rs_b / mib:.1f} MiB) "
        f"in {rs_s * 1e3:.1f} ms ({rs_b / 1e9 / max(rs_s, 1e-9):.2f} GB/s), "
        f"tier {tier.stats()}; launches {c}")
    fleet_check("fleet host tier", {
        "the prefix spilled": tier.spilled_pages_total > 0,
        "the returning request restored it":
            tier.restored_pages_total > 0
            and srvs["tiered"].stats["prefix_auto_hit_tokens"] > 0,
        "tokens equal the never-evicted run's":
            all(np.array_equal(a, b) for a, b in zip(outs["oracle"],
                                                     outs["tiered"])),
        "live == 0": srvs["tiered"].pool_balance()[1] == 0,
        **gates})
    del srvs, srv
    release()

    # ---- disaggregated: one prefill specialist, two decode replicas,
    # against a hybrid fleet of three on the same traffic
    res = {}
    for place in ("disaggregated", "hybrid"):
        if place == "disaggregated":
            reps = [ContinuousBatchingServer(model, role="prefill", **kw),
                    ContinuousBatchingServer(model, role="decode", **kw),
                    ContinuousBatchingServer(model, role="decode", **kw)]
            router = ReplicaRouter(reps, placement="disaggregated",
                                   disagg_prefill_min_tokens=256,
                                   telemetry=True)
        else:
            reps = [ContinuousBatchingServer(model, **kw)
                    for _ in range(3)]
            router = ReplicaRouter(reps, telemetry=True)
        before = fleet_stats(reps)
        zero_counts()
        t0 = time.perf_counter()
        rids = [router.submit(p, max_new_tokens=n_new, seed=80 + i)
                for i, p in enumerate(stems)]
        fleet_drive(router, reps)
        outs = [router.wait(r, timeout=300) for r in rids]
        wall = time.perf_counter() - t0
        c = read_counts()
        d, gates = fleet_launch_gates(c, before, fleet_stats(reps), L, False)
        reg = router.telemetry.registry.snapshot()
        h = reg.get("serving_handoff_seconds", {}).get("samples", {}).get(
            (), {})
        res[place] = dict(outs=outs, wall=wall, stats=router.stats,
                          counts=c, gates=gates, handoff=h,
                          dec_prefill=[r.stats["prefill_tokens"]
                                       for r in reps],
                          bal=[tuple(r.pool_balance()) for r in reps])
        del router, reps
        release()
    dg = res["disaggregated"]
    long_n = sum(1 for p in stems if len(p) >= 256)
    short_tokens = sum(len(p) for p in stems if len(p) < 256)
    h = dg["handoff"]
    agree = sum(int((a == b).sum()) for a, b in
                zip(dg["outs"], res["hybrid"]["outs"]))
    for place, r in res.items():
        log(f"fleet {place} [{card}]: {8 * n_new / r['wall']:.1f} tok/s "
            f"over {r['wall']:.3f} s, routed {r['stats']['routed']}, "
            f"handoffs {r['stats']['handoffs']} (fallbacks "
            f"{r['stats']['handoff_fallbacks']}), prefill tokens by replica "
            f"{r['dec_prefill']}, launches {r['counts']}")
    log(f"fleet disaggregated handoff latency [{card}]: "
        f"{h.get('count', 0)} handoffs, mean "
        f"{1e3 * h.get('sum', 0.0) / max(h.get('count', 0), 1):.1f} ms "
        f"(pump start to commit); tokens agree with the hybrid fleet on "
        f"{agree} of {8 * n_new} (informational: prefill chunk shapes "
        f"differ)")
    fleet_check("fleet disaggregated", {
        "every long prompt handed off": dg["stats"]["handoffs"] == long_n
        and dg["stats"]["handoff_fallbacks"] == 0,
        "handed-off requests prefilled 0 rows on their targets":
            sum(dg["dec_prefill"][1:]) == short_tokens,
        "32 in-vocabulary tokens each": all(
            len(o) == n_new and o.min() >= 0 and o.max() < V
            for o in dg["outs"]),
        "live == 0 everywhere": all(b[1] == 0 for b in dg["bal"]),
        **dg["gates"], **{f"hybrid: {k}": v
                          for k, v in res["hybrid"]["gates"].items()}})
    log(f"fleet: {time.perf_counter() - t_phase:.1f} s")
    return model


def wire_parity_run(np, model):
    """One pass of the wire_parity scripts on ``model`` (llama_tiny in
    f32): ``ReplicaHost``s on threads of this process serve
    ``ContinuousBatchingServer``s of the model behind ``RemoteReplica``s.
    Returns {scenario: tokens}, {scenario: launch counts} and
    {scenario: launch gates} (the gates hold only on the card)."""
    from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                            RemoteReplica, ReplicaHost,
                                            ReplicaRouter)
    V, L = model.cfg.vocab_size, model.cfg.num_layers
    rng = np.random.default_rng(12)
    kw = dict(max_slots=2, max_cache_len=64, cache_backend="paged",
              page_size=8, prefill_tokens_per_tick=16)
    sample = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    toks, counts, gates = {}, {}, {}
    opened = []

    def pair(k):
        srvs = [ContinuousBatchingServer(model, **k) for _ in range(2)]
        hosts = [ReplicaHost(s).start() for s in srvs]
        reps = [RemoteReplica(h.address) for h in hosts]
        opened.append((reps, hosts, srvs))
        return srvs, reps

    def live(reps):
        return [r.pool_balance()[1] for r in reps]

    try:
        # waves through a round-robin router, every prompt submitted
        # before the replicas start (the admission grouping is fixed)
        wave = [rng.integers(0, V, (int(n),)).astype(np.int32)
                for n in (9, 20, 13, 30)]
        for mode in ("split", "fused"):
            for s in (False, True):
                name = f"wave {mode} {'sampled' if s else 'greedy'}"
                srvs, reps = pair(dict(kw, serving_mode=mode,
                                       **(sample if s else {})))
                router = ReplicaRouter(reps, policy="round_robin")
                router.start(poll_interval=0.01, start_replicas=False)
                before = fleet_stats(srvs)
                zero_counts()
                rids = [router.submit(p, max_new_tokens=8, seed=30 + i)
                        for i, p in enumerate(wave)]
                for rep in reps:
                    rep.start()
                toks[name] = [router.wait(r, timeout=300) for r in rids]
                router.stop(drain=True, timeout=120)
                counts[name] = read_counts()
                _, gates[name] = fleet_launch_gates(
                    counts[name], before, fleet_stats(srvs), L, s)
                fleet_check(f"wire_parity {name}", {
                    "8 tokens each": all(len(t) == 8 for t in toks[name]),
                    "routed 2 and 2": router.stats["routed"] == [2, 2],
                    "no request failed": router.failures == {},
                    "live == 0 on both, over the wire":
                        live(reps) == [0, 0]})
        # one request moved A -> B mid-decode over the wire
        p_mig = rng.integers(0, V, (37,)).astype(np.int32)
        for mode in ("split", "fused"):
            name = f"move {mode}"
            k = dict(kw, serving_mode=mode)
            ref = serve_wave(ContinuousBatchingServer(model, **k), [p_mig],
                             16, [9])[0]
            srvs, reps = pair(k)
            before = fleet_stats(srvs)
            zero_counts()
            rid = reps[0].submit(p_mig, max_new_tokens=16, seed=9)
            src = srvs[0]
            while src._slots[0] is None or len(src._slots[0].emitted) < 5:
                src.step()
            state, payloads = reps[0].migrate_out(rid)
            new = reps[1].migrate_in(state, payloads)
            moved = reps[0].migrate_finish(rid)
            reps[1].start()
            out = reps[1].wait(new, timeout=300)
            reps[1].stop(drain=True, timeout=120)
            toks[name] = (ref, out)
            counts[name] = read_counts()
            _, gates[name] = fleet_launch_gates(
                counts[name], before, fleet_stats(srvs), L, False)
            fleet_check(f"wire_parity {name}", {
                "tokens equal the never-moved run's":
                    np.array_equal(ref, out),
                "committed": moved is True,
                "every frame's and page's sha256 held, zero re-prefill on "
                "B": srvs[1].stats["migrated_in"] == 1
                and srvs[1].stats["prefill_tokens"] == 0,
                "live == 0 on both, over the wire": live(reps) == [0, 0]})
        # a polite kill of a host holding queued work
        name = "kill"
        k = dict(kw)
        wave5 = [rng.integers(0, V, (int(n),)).astype(np.int32)
                 for n in (9, 12, 20, 7, 15)]
        ref = serve_wave(ContinuousBatchingServer(model, **k), wave5, 6,
                         list(range(5)))
        srvs, reps = pair(k)
        router = ReplicaRouter(reps, policy="round_robin")
        router.start(poll_interval=0.01, start_replicas=False)
        before = fleet_stats(srvs)
        zero_counts()
        rids = [router.submit(p, max_new_tokens=6, seed=i)
                for i, p in enumerate(wave5)]
        queued = srvs[0].queue_depth()
        reps[0].kill()
        deadline = time.monotonic() + 60
        while router.stats["requeued"] < queued:
            if time.monotonic() > deadline:
                raise SystemExit(f"wire_parity kill: no failover "
                                 f"{router.stats}")
            time.sleep(0.01)
        reps[1].start()
        got = [router.wait(r, timeout=300) for r in rids]
        router.stop(drain=True, timeout=120, stop_replicas=False)
        reps[1].stop(drain=True, timeout=120)
        toks[name] = (ref, got)
        counts[name] = read_counts()
        _, gates[name] = fleet_launch_gates(
            counts[name], before, fleet_stats(srvs), L, False)
        fleet_check("wire_parity kill", {
            "the killed host held 3 queued requests": queued == 3,
            "every request completed on the sibling, equal to the "
            "never-killed run's": all(np.array_equal(g, r)
                                       for g, r in zip(got, ref)),
            "no request failed": router.failures == {},
            "live == 0 on both, the killed host too, over the wire":
                live(reps) == [0, 0]})
    finally:
        for reps, hosts, srvs in opened:
            for rep in reps:
                rep.close()
            for host in hosts:
                host.close()
            for srv in srvs:
                if srv._thread is not None:
                    srv.stop(timeout=60)
    return toks, counts, gates


def phase_wire_parity(torch, np):
    """llama_tiny in f32 served over the wire on the card against the
    same scripts on the CPU (see the module docstring)."""
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    cfg = llama_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    t0 = time.perf_counter()
    cpu_toks, cpu_counts, _ = wire_parity_run(np, cpu)
    card_toks, card_counts, card_gates = wire_parity_run(np, gpu)

    def flat(runs):
        out = []
        for r in (runs if isinstance(runs, (list, tuple)) else [runs]):
            out.extend(r if isinstance(r, (list, tuple)) else [r])
        return out

    checks = {}
    for name in cpu_toks:
        a, b = flat(card_toks[name]), flat(cpu_toks[name])
        checks[f"{name}: the card's tokens equal the CPU's"] = \
            len(a) == len(b) and all(np.array_equal(x, y)
                                     for x, y in zip(a, b))
        checks[f"{name}: no launch on the CPU"] = \
            not any(cpu_counts[name].values())
        for g, good in card_gates[name].items():
            checks[f"{name}: {g}"] = good
        same = checks[f"{name}: the card's tokens equal the CPU's"]
        log(f"wire_parity {name}: card tokens equal to the CPU's {same}, "
            f"card launches {card_counts[name]}")
    log(f"wire_parity: {time.perf_counter() - t0:.1f} s")
    fleet_check("wire_parity", checks)


# the wire phase's client thresholds: a digest older than these reads
# draining / dead. Both sit above the longest gap the phase measures
# between two digests of a healthy 7B host (gated), so only a host that
# stopped reads as either.
WIRE_DRAINING_S = 2.0
WIRE_DEAD_S = 4.0


def wire_factory(warm, counts_path):
    """The wire phase's replica factory, run in each spawned child:
    Llama-2-7B bf16 from seed 0 on the card (the parent's bits), a split
    server of the serve geometry, and serve_timed's warm request run
    before the host listens. Smoke instrumentation only, no wire op:
    the migration parts are timed into ``stats`` (``wire_*_s``, read
    over the wire), and an ``atexit`` hook writes the child's launch
    counts and build seconds to ``counts_path``."""
    import atexit
    import hashlib
    import types
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.inference import continuous_batching as cb
    from paddle_tpu_torch.inference import transport
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.ops.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = LlamaForCausalLM(llama2_7b(), device="cuda",
                             dtype=torch.bfloat16, seed=0)
    srv = ContinuousBatchingServer(model, max_slots=8, max_cache_len=2048,
                                   page_size=16, cache_backend="paged",
                                   prefill_tokens_per_tick=512,
                                   serving_mode="split")
    srv.submit(np.asarray(warm, np.int32), max_new_tokens=2)
    srv.run()
    torch.cuda.synchronize()
    srv.stats["wire_ready_s"] = time.perf_counter() - t0
    srv.stats["wire_build_s"] = _build.build_seconds()

    def timed(key, fn, sync=False):
        srv.stats[key] = 0.0

        def f(*a, **k):
            t = time.perf_counter()
            try:
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                srv.stats[key] += time.perf_counter() - t
        return f

    srv._gather_pages = timed("wire_gather_s", srv._gather_pages)
    srv._scatter_pages = timed("wire_scatter_s", srv._scatter_pages,
                               sync=True)
    cb._sha256 = timed("wire_server_sha256_s", cb._sha256)
    transport.hashlib = types.SimpleNamespace(
        sha256=timed("wire_frame_sha256_s", hashlib.sha256))

    def dump():
        with open(counts_path, "w") as f:
            json.dump({"counts": read_counts(), "pid": os.getpid(),
                       "build_s": _build.build_seconds()}, f)

    atexit.register(dump)
    return srv


def wire_memory(torch, tag):
    free, total = torch.cuda.mem_get_info()
    try:
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        apps = f"nvidia-smi failed: {e!r}"
    log(f"wire memory {tag}: card free {free / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB (parent's mem_get_info); compute apps "
        f"(pid, used): {apps or 'none listed'}")


def phase_wire(torch, np, card, model, serve_res):
    """Llama-2-7B in two spawned replica processes behind the wire (see
    the module docstring)."""
    import gc
    import hashlib
    import signal
    import tempfile
    import threading
    import types
    import urllib.error
    import urllib.request
    from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                            RemoteReplica, ReplicaRouter,
                                            serve_metrics,
                                            spawn_replica_host, transport)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    cfg = llama2_7b()
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(0)                 # the serve phase's
    lens = rng.integers(128, 1025, size=8)
    prompts = [rng.integers(0, V, (int(n),)).astype(np.int32)
               for n in lens]
    warm = rng.integers(0, V, (40,)).astype(np.int32)
    n_new = 32
    checks = {}
    if serve_res is not None:
        want = serve_res["split"][0]["tokens"]
    else:
        if model is None:
            model = LlamaForCausalLM(cfg, device="cuda",
                                     dtype=torch.bfloat16, seed=0)
        srv = ContinuousBatchingServer(model, max_slots=8,
                                       max_cache_len=2048, page_size=16,
                                       cache_backend="paged",
                                       prefill_tokens_per_tick=512,
                                       serving_mode="split")
        want = serve_timed(torch, np, srv, prompts, n_new, warm)["tokens"]
        del srv
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-wire-")
    procs, reps, started, errors = {}, {}, {}, []
    router = ms = None

    def spawn(tag):
        try:
            t = time.perf_counter()
            proc, addr = spawn_replica_host(
                wire_factory, {"warm": warm.tolist(), "counts_path":
                               os.path.join(tmp.name, f"{tag}.json")},
                heartbeat_s=0.02, startup_timeout=300.0)
            procs[tag] = proc
            started[tag] = (addr, time.perf_counter() - t)
        except Exception as e:
            errors.append(e)

    arrivals = {"A": [], "B": []}
    try:
        t_spawn = time.perf_counter()
        threads = [threading.Thread(target=spawn, args=(tag,))
                   for tag in ("A", "B")]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        log(f"wire [{card}]: two Llama-2-7B bf16 replica processes "
            f"started together in {time.perf_counter() - t_spawn:.1f} s "
            f"(A {started['A'][1]:.1f} s, B {started['B'][1]:.1f} s: "
            f"interpreter, CUDA, weights from seed 0, the warm request); "
            f"pids A {procs['A'].pid} B {procs['B'].pid}")
        for tag in ("A", "B"):
            rep = RemoteReplica(started[tag][0], name=f"replica-{tag}",
                                draining_after_s=WIRE_DRAINING_S,
                                dead_after_s=WIRE_DEAD_S)
            inner = rep._on_digest

            def on_digest(d, _tag=tag, _inner=inner):
                arrivals[_tag].append(time.monotonic())
                _inner(d)

            rep._on_digest = on_digest
            reps[tag] = rep
        ra, rb = reps["A"], reps["B"]
        wire_memory(torch, "after both children started")
        ready = {tag: reps[tag].stats.get("wire_ready_s") for tag in reps}
        built = {tag: reps[tag].stats.get("wire_build_s") for tag in reps}
        log(f"wire: in-child build of model, server and warm request "
            f"{ready} s; kernel compile seconds in the children {built}")
        checks["the children compiled no kernel (they loaded the build "
               "phase's libraries)"] = all(b == 0.0 for b in built.values())
        t_serve = time.monotonic()

        # ---- parity: each child takes the serve prompts, then starts
        t0 = time.perf_counter()
        rids = {tag: [reps[tag].submit(p, max_new_tokens=n_new)
                      for p in prompts] for tag in reps}
        for rep in reps.values():
            rep.start()
        outs = {tag: [reps[tag].wait(r, timeout=600) for r in rids[tag]]
                for tag in reps}
        t_par = time.perf_counter() - t0
        for tag, out in outs.items():
            same = sum(int((a == b).sum()) for a, b in zip(out, want))
            log(f"wire parity {tag} [{card}]: greedy tokens equal the serve "
                f"phase's split wave on {same} of {8 * n_new}; both "
                f"children's waves together {t_par:.2f} s")
            checks[f"parity {tag}: 256 of 256 tokens equal serve's split "
                   f"wave"] = same == 8 * n_new \
                and all(len(o) == n_new for o in out)

        # ---- a wire move A -> B after 8 tokens
        mig = np.random.default_rng(3).integers(0, V, (900,)).astype(
            np.int32)
        ref = rb.wait(rb.submit(mig, max_new_tokens=24, seed=11),
                      timeout=600)
        got = []
        rid = ra.submit(mig, max_new_tokens=24, seed=11,
                        on_token=lambda r, t: got.extend(int(x) for x in t))
        deadline = time.monotonic() + 300
        while len(got) < 8:
            if time.monotonic() > deadline:
                raise SystemExit("wire: the move's request never streamed "
                                 "8 tokens")
            time.sleep(0.002)
        hash_s = [0.0]

        def parent_sha256(data=b""):
            t = time.perf_counter()
            h = hashlib.sha256(data)
            hash_s[0] += time.perf_counter() - t
            return h

        saved = transport.hashlib
        transport.hashlib = types.SimpleNamespace(sha256=parent_sha256)
        try:
            sa0, sb0 = ra._call("stats"), rb._call("stats")
            t0 = time.perf_counter()
            state, payloads = ra.migrate_out(rid)
            t_out = time.perf_counter() - t0
            t0 = time.perf_counter()
            new = rb.migrate_in(state, payloads,
                                on_token=lambda r, t: got.extend(
                                    int(x) for x in t))
            t_in = time.perf_counter() - t0
        finally:
            transport.hashlib = saved
        committed = ra.migrate_finish(rid)
        out = rb.wait(new, timeout=600)
        sa1, sb1 = ra._call("stats"), rb._call("stats")

        def part(s1, s0, key):
            return s1[key] - s0[key]

        nbytes = sum(p.nbytes for p in payloads)
        gb = nbytes / 1e9
        parts = {"A gather (device gather + copy to host)":
                     part(sa1, sa0, "wire_gather_s"),
                 "A state sha256 (server)":
                     part(sa1, sa0, "wire_server_sha256_s"),
                 "A frame sha256 (send_pages)":
                     part(sa1, sa0, "wire_frame_sha256_s"),
                 "parent frame sha256 (recv from A + send_pages to B)":
                     hash_s[0],
                 "B frame sha256 (recv)":
                     part(sb1, sb0, "wire_frame_sha256_s"),
                 "B page sha256 (server migrate_in)":
                     part(sb1, sb0, "wire_server_sha256_s"),
                 "B scatter (copy to card + index_copy_)":
                     part(sb1, sb0, "wire_scatter_s")}
        e2e = t_out + t_in
        rest = e2e - sum(parts.values())
        log(f"wire move [{card}]: {len(payloads)} page frames of "
            f"{payloads[0].nbytes} bytes ({payloads[0].dtype}, page_dtype "
            f"{state.get('page_dtype')}), {nbytes / 2**20:.1f} MiB; "
            f"migrate_out {t_out * 1e3:.1f} ms, migrate_in "
            f"{t_in * 1e3:.1f} ms, end to end {e2e * 1e3:.1f} ms "
            f"({gb / e2e:.3f} GB/s); " + "; ".join(
                f"{k} {v * 1e3:.1f} ms ({gb / max(v, 1e-9):.2f} GB/s)"
                for k, v in parts.items())
            + f"; the rest (loopback socket, framing and host copies) "
            f"{rest * 1e3:.1f} ms")
        checks["move: 57 page frames of exactly 8,388,608 bytes, uint16 "
               "bits of a bf16 pool"] = len(payloads) == 57 and all(
            p.nbytes == 8388608 and p.dtype == np.uint16 for p in payloads) \
            and state.get("page_dtype") == "bfloat16"
        checks["move: tokens equal the never-moved run's (24 of 24)"] = \
            np.array_equal(out, ref) and len(out) == 24
        checks["move: the stream carried every token once"] = \
            got == [int(t) for t in out]
        checks["move: committed, B prefilled nothing for it"] = \
            committed is True and sb1["migrated_in"] == 1 and \
            sb1["prefill_tokens"] == sb0["prefill_tokens"]

        # ---- the SIGKILL drill, behind RouterSupervisor
        gaps = {}
        router = ReplicaRouter([ra, rb], policy="least_loaded",
                               telemetry=True, journeys=True,
                               recorder=True)
        ms = serve_metrics(router)
        router.start(poll_interval=0.02, start_replicas=False)
        drng = np.random.default_rng(5)
        wave = [drng.integers(0, V, (int(n),)).astype(np.int32)
                for n in drng.integers(64, 256, size=20)]
        streams = {}
        sub_ms = []
        rids = []
        for i, p in enumerate(wave):
            ts = time.perf_counter()
            r = router.submit(p, max_new_tokens=n_new, seed=50 + i,
                              on_token=lambda r_, t, _i=i: streams.setdefault(
                                  _i, []).extend(int(x) for x in t))
            sub_ms.append((time.perf_counter() - ts) * 1e3)
            rids.append(r)
        deadline = time.monotonic() + 300
        while True:
            q, f = ra._mirror_counts()
            if q >= 1 and f >= 1:
                break
            if time.monotonic() > deadline:
                raise SystemExit("wire drill: A never held queued and "
                                 "mid-decode work")
            time.sleep(0.002)
        for tag, ts in arrivals.items():
            live_ts = [t for t in ts if t >= t_serve]
            gaps[tag] = max([b - a for a, b in zip(live_ts, live_ts[1:])]
                            + [0.0])
        # freeze A: its digests stop while its connection stays open
        os.kill(procs["A"].pid, signal.SIGSTOP)
        t_freeze = time.monotonic()
        dead_seen = wire_open = age = None
        while time.monotonic() - t_freeze < 60:
            if ra.health == "dead":
                dead_seen = time.monotonic() - t_freeze
                wire_open = not ra._wire_dead()
                age = ra._clock.now() - ra._last_hb
                break
            time.sleep(0.01)
        # A sent nothing since the freeze and its client has read every
        # frame sent before it: the mirror is final
        with router._lock:
            on_a = {rid: rt.rrid for rid, rt in router._routes.items()
                    if rt.idx == 0}
        with ra._state_lock:
            mirrors = {m.rid: len(m.tokens) for m in ra._mirror.values()
                       if not m.done}
        os.kill(procs["A"].pid, signal.SIGKILL)
        procs["A"].join(30)
        health_codes = []
        done = threading.Event()

        def poll_health():
            while not done.is_set():
                try:
                    health_codes.append(urllib.request.urlopen(
                        ms.url + "/healthz", timeout=10).status)
                except urllib.error.HTTPError as e:
                    health_codes.append(e.code)
                except OSError:
                    health_codes.append(None)
                done.wait(0.2)

        hp = threading.Thread(target=poll_health)
        hp.start()
        try:
            res = {r: router.wait(r, timeout=600) for r in rids}
        finally:
            done.set()
            hp.join(30)
        st = router.stats
        queued = [i for i, r in enumerate(rids)
                  if mirrors.get(on_a.get(r)) == 0]
        mid = [i for i, r in enumerate(rids)
               if (mirrors.get(on_a.get(r)) or 0) > 0]
        bal_b = rb.pool_balance()
        path = os.path.join(tmp.name, "fleet.json")
        router.export_fleet_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]

        def pids_of(i):
            flows = [e for e in evs if e.get("cat") == "journey"
                     and e.get("id") == f"r{rids[i]}"]
            return {e["pid"] for e in flows} if flows and \
                flows[0]["ph"] == "s" and flows[-1]["ph"] == "f" else set()

        log(f"wire drill [{card}]: digest gaps while serving, longest "
            f"A {gaps['A'] * 1e3:.1f} ms B {gaps['B'] * 1e3:.1f} ms "
            f"(clients' draining_after_s {WIRE_DRAINING_S}, dead_after_s "
            f"{WIRE_DEAD_S}); router host ms a submit median "
            f"{sorted(sub_ms)[len(sub_ms) // 2]:.3f} max {max(sub_ms):.3f}; "
            f"A frozen with {len(queued)} queued and {len(mid)} mid-decode "
            f"requests, read dead {dead_seen} s later (last digest {age} s "
            f"old) with its connection open {wire_open}; after SIGKILL: "
            f"evacuations {st['evacuations']}, requeued {st['requeued']}, "
            f"queued ones' lengths {[len(res[rids[i]]) for i in queued]}, "
            f"partials {[len(res[rids[i]]) for i in mid]}; "
            f"B pool {tuple(bal_b) if bal_b is not None else None}; "
            f"/healthz codes while B served {sorted(set(health_codes))} "
            f"({len(health_codes)} polls)")
        checks["digest gaps of a healthy 7B host below draining_after_s"] = \
            max(gaps.values()) < WIRE_DRAINING_S
        checks["A read dead from stale digests alone (connection open)"] = \
            dead_seen is not None and wire_open is True \
            and age >= WIRE_DEAD_S
        checks["A held queued and mid-decode work"] = \
            len(queued) >= 1 and len(mid) >= 1
        checks["A's queued requests requeued on B with full budgets"] = \
            st["evacuations"] >= 1 and st["requeued"] >= len(queued) and \
            all(len(res[rids[i]]) == n_new for i in queued)
        checks["mid-decode requests flushed exactly their streamed "
               "partials"] = all(
            len(res[rids[i]]) == mirrors[on_a[rids[i]]] < n_new
            and [int(t) for t in res[rids[i]]] == streams.get(i)
            for i in mid)
        checks["every other request finished, none failed"] = \
            router.failures == {} and all(
                len(res[rids[i]]) == n_new for i in range(len(rids))
                if i not in mid)
        checks["B ends with live == 0"] = bal_b is not None and bal_b[1] == 0
        checks["a failed-over request's journey spans two pids"] = any(
            len(pids_of(i)) >= 2 for i in queued)
        checks["/healthz 200 while B served"] = \
            bool(health_codes) and set(health_codes) == {200}
        router.stop(drain=False, timeout=60, stop_replicas=False)
        ms.close()
        ms = router = None

        # ---- B: stopped, shut down; its counts written at exit
        rb.stop(drain=True, timeout=120)
        sb = rb._call("stats")
        rb.shutdown()
        procs["B"].join(120)
        with open(os.path.join(tmp.name, "B.json")) as f:
            child = json.load(f)
        c = child["counts"]
        zero = {k: 0 for k in ("decode_ticks", "prefill_launches",
                               "fused_passes", "sample_launches")}
        _, gates = fleet_launch_gates(
            c, zero, {k: sb[k] for k in zero}, L, False)
        log(f"wire B's launches at exit (pid {child['pid']}, exit code "
            f"{procs['B'].exitcode}, compiled {child['build_s']} s): {c}; "
            f"its stats decode ticks {sb['decode_ticks']}, prefill launches "
            f"{sb['prefill_launches']}")
        checks.update({f"B launches: {k}": v for k, v in gates.items()})
        checks["B launches: k1 + k2 > 0"] = c["k1"] + c["k2"] > 0
        checks["B exited cleanly"] = procs["B"].exitcode == 0
        wire_memory(torch, "after the drill")
    finally:
        if router is not None:
            router.stop(drain=False, timeout=60, stop_replicas=False)
        if ms is not None:
            ms.close()
        for rep in reps.values():
            rep.close()
        for proc in procs.values():
            if proc.is_alive():
                proc.kill()
            proc.join(30)
        tmp.cleanup()
    log(f"wire: checks {checks}")
    fleet_check("wire", checks)


def family_models():
    """(name, model class, tiny config, full-width config) of the three
    families the decode bundles serve."""
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         MixtralForCausalLM, gpt2_345m,
                                         gpt2_tiny, llama2_7b, llama_tiny,
                                         mixtral_8x7b, mixtral_tiny)
    return (("gpt2", GPTForCausalLM, gpt2_tiny(), gpt2_345m()),
            ("mixtral", MixtralForCausalLM, mixtral_tiny(),
             mixtral_8x7b(num_layers=8)),
            ("llama", LlamaForCausalLM, llama_tiny(), llama2_7b()))


def phase_family_parity(torch, np):
    """gpt2_tiny, mixtral_tiny and llama_tiny in float32 (weights from
    seed 3, copied to the card) served on the card and on the CPU: paged
    split and fused waves, greedy and seeded sampled, then split and
    fused with int8 weights, then the dense server with an int8 cache.
    The card's tokens must equal the CPU's; K1 and K2 launched on split
    waves, K3 on fused ones, R1 once a draw, nothing on the dense
    waves, nothing on the CPU."""
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import export_params, load_jax_params
    rng = np.random.default_rng(5)
    wave1 = [rng.integers(0, 256, (n,)).astype(np.int32)
             for n in (1, 7, 8, 13, 17, 30)]
    wave2 = [np.concatenate([wave1[5][:16],
                             rng.integers(0, 256, (n,)).astype(np.int32)])
             for n in (3, 9)]
    seeds = [0, 2**31 - 1, 2**31, -1, 2**32 - 1, 12345]
    sample = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
                  seed=2**31 - 4)
    paged = dict(cache_backend="paged", page_size=8,
                 prefill_tokens_per_tick=5)
    int8 = dict(weight_dtype="int8")
    cases = (("split", paged, {}), ("fused", paged, {}),
             ("sampled split", paged, sample),
             ("sampled fused", paged, sample),
             ("int8 split", paged, int8), ("int8 fused", paged, int8),
             ("int8-cache dense", dict(cache_backend="dense"),
              dict(cache_dtype="int8")))
    good = True
    for fam, cls, cfg, _ in family_models():
        cpu = cls(cfg, device="cpu", seed=3)
        gpu = cls(cfg, device="cuda")
        load_jax_params(gpu, export_params(cpu))
        for case, backend, kw in cases:
            mode = case.split()[-1]
            toks, draws = {}, 0
            for name, model in (("cpu", cpu), ("cuda", gpu)):
                zero_counts()
                srv = ContinuousBatchingServer(
                    model, max_slots=3, max_cache_len=64,
                    serving_mode="fused" if mode == "fused" else "split",
                    **backend, **kw)
                toks[name] = serve_wave(
                    srv, wave1, 7, seeds if "sampled" in case else None) \
                    + serve_wave(srv, wave2, 7)
                n = read_counts()
                draws = srv.stats["sample_launches"]
                bal = srv.pool_balance()
                live = 0 if bal is None else bal[1]
                want = {"split": ("k1", "k2"), "fused": ("k3",),
                        "dense": ()}[mode]
                if name == "cuda":
                    launched = all(n[k] > 0 for k in want) \
                        and n["r1"] == draws \
                        and not any(v for k, v in n.items()
                                    if k not in want + ("r1",))
                else:
                    launched = not any(n.values())
                bad = srv.stats["nonfinite_logit_rows"]
                log(f"family_parity {fam} {case} {name}: {draws} draws, "
                    f"live pages {live}, non-finite rows {bad}, launches "
                    f"{ {k: v for k, v in n.items() if v} }")
                good &= launched and live == 0 and bad == 0
            same = all(np.array_equal(a, b)
                       for a, b in zip(toks["cuda"], toks["cpu"]))
            log(f"family_parity {fam} {case}: card tokens equal to the "
                f"CPU's {same}")
            good &= same and ("sampled" not in case or draws > 0)
        del cpu, gpu
    torch.cuda.empty_cache()
    if not good:
        raise SystemExit("family_parity: the card and the CPU disagree, "
                         "or a wave's launches are not its path's")


def family_prompts(np, vocab):
    """The families phase's wave: 8 prompts of 100-700 tokens and a
    40-token warm-up prompt, from seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 701, size=8)
    prompts = [rng.integers(0, vocab, (int(n),)).astype(np.int32)
               for n in lens]
    return prompts, rng.integers(0, vocab, (40,)).astype(np.int32)


def quantized_bytes(weights):
    """Bytes of the int8 codes and f32 scales among a bundle's per-layer
    weights (``step_fn.weights``)."""
    return sum(t.numel() * t.element_size() for blk in weights
               for w in blk.values() if isinstance(w, tuple) for t in w)


def projection_bytes(weights):
    """Bytes of the matrices the int8 bundle quantizes, as a float
    bundle reads them."""
    from paddle_tpu_torch.models.generation import _QUANT_WEIGHTS
    return sum(w.numel() * w.element_size() for blk in weights
               for k, w in blk.items() if k in _QUANT_WEIGHTS)


def family_wave(torch, np, card, tag, model, prompts, warm, L, vocab,
                **kw):
    """One timed wave (``serve_timed``) through a new server built with
    ``kw``, the peak memory of the build (an int8 bundle quantizes
    there) and of the wave apart; its gates
    as the serve phase's (32 in-vocabulary tokens each, no non-finite
    live logits, the pool drained, launches = ticks x layers, no R1, no
    R2, no K6). Returns serve_timed's result with ``peak_gib``,
    ``build_s`` and, for an int8 server, ``int8_weights`` (the bundle's
    quantized layers)."""
    import gc
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = ContinuousBatchingServer(model, max_slots=8, page_size=16,
                                   prefill_tokens_per_tick=512, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    r = serve_timed(torch, np, srv, prompts, 32, warm)
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    r["build_s"] = build_s
    if kw.get("weight_dtype") == "int8":
        r["int8_weights"] = srv._step_fn.weights
    c = r["counts"]
    mode = "dense" if kw.get("cache_backend") == "dense" \
        else kw.get("serving_mode", "split")
    log(f"families {tag}: {r['ticks']} ticks ({r['decode_ticks']} decode, "
        f"{r['prefill_launches']} prefill launches, {r['fused_launches']} "
        f"fused launches in {r['fused_passes']} passes), launches "
        f"{ {k: v for k, v in c.items() if v} }, non-finite live logit rows "
        f"{r['bad']}, pool {r['pool']}, server built in {build_s:.2f} s "
        f"(peak memory while building {build_gib:.2f} GiB)")
    log(f"families metrics {tag} [{card}]: wall {r['wall']:.3f} s, "
        f"{r['tok_s']:.1f} tok/s, median decode-only tick (TPOT) "
        f"{r['decode_ms']:.2f} ms, TTFT median {r['ttft_med']:.1f} ms max "
        f"{r['ttft_max']:.1f} ms, peak memory {r['peak_gib']:.2f} GiB")
    if mode == "split":
        launch = {"k1 == decode ticks x layers":
                      c["k1"] == r["decode_ticks"] * L > 0,
                  "k2 == prefill launches x layers":
                      c["k2"] == r["prefill_launches"] * L > 0,
                  "no k3 launch": c["k3"] == 0}
    elif mode == "fused":
        launch = {"k3 == fused passes x layers":
                      c["k3"] == r["fused_passes"] * L > 0,
                  "no k1 or k2 launch": c["k1"] == c["k2"] == 0}
    else:
        launch = {"no k1, k2 or k3 launch (dense attention)":
                      c["k1"] == c["k2"] == c["k3"] == 0}
    checks = {"32 in-vocabulary tokens each":
                  all(len(t) == 32 and t.min() >= 0 and t.max() < vocab
                      for t in r["tokens"]),
              "no non-finite live logits": r["bad"] == 0,
              "pool drained (live == 0)":
                  r["pool"] is None or r["pool"][1] == 0,
              "no r1, r2 or k6 launch":
                  c["r1"] == c["r2_dropout"] == c["r2_fill"] == c["k6"]
                  == c["k6_qk"] == 0,
              **launch}
    for name, ok in checks.items():
        if not ok:
            raise SystemExit(f"families {tag}: check failed: {name}")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return r


def int8_checks(torch, tag, model, mcl, prompt, int8, bf16):
    """The int8 gates of one model: its int8 bundle's weight bytes
    within 2% of half its bf16 projections' bytes; the first token's
    logits of ``prompt`` within the rule of ``tests/test_generation.py``
    (max |int8 - bf16| under 5% of max |bf16 logit|). Reports (not
    gated) how many of the int8 wave's tokens equal the bf16 wave's."""
    qbytes = quantized_bytes(int8["int8_weights"])
    fbytes = projection_bytes(model._decode_bundle(mcl)[2].weights)
    ids = prompt[None]
    lf, _ = model._run_prefill(model._decode_bundle(mcl), ids)
    l8, _ = model._run_prefill(model._decode_bundle(mcl, "int8"), ids)
    rel = ((l8 - lf).abs().max() / lf.abs().max()).item()
    agree = sum(int((a == b).sum()) for a, b in
                zip(int8["tokens"], bf16["tokens"]))
    total = sum(len(t) for t in bf16["tokens"])
    log(f"families {tag} int8: {qbytes} bytes of int8 weights and scales "
        f"against {fbytes} bytes of bf16 projections "
        f"({qbytes / fbytes:.4f}x); first-token logits max |int8 - bf16| "
        f"{rel:.4f} of max |bf16| (rule < 0.05); int8 and bf16 split "
        f"tokens agree on {agree} of {total} (informational)")
    checks = {"int8 weights within 2% of half the bf16 projections":
                  abs(qbytes - fbytes / 2) <= 0.02 * fbytes / 2,
              "int8 first-token logits within 5% of max |bf16 logit|":
                  rel < 0.05}
    del int8["int8_weights"]       # the last reference outside the model
    for name, ok in checks.items():
        if not ok:
            raise SystemExit(f"families {tag}: check failed: {name}")


def family_kernel_times(torch, peak, record, tag, nh, kvh, hd):
    """K1, K2 and K3 alone at a family's heads over the families waves'
    geometry (8 slots, 64 pages of 16 tokens: a 1024-token cache), in
    bf16: each held against its plain version (TOL, VEC_RTOL), then
    timed beside it, one SDPA call (a yardstick) and its bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_tick as ft
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_prefill as rp
    S, pg, maxp = 8, 16, 64
    T = maxp * pg
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp, dt, gen)
    scale = hd ** -0.5
    lens = [1, 17, 140, 333, 512, 700, 900, T]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn((S, nh, hd), generator=gen, device="cuda").to(dt)
    out = pa.paged_attention(q, kp, vp, bt, lengths, scale)
    ref = pa._ref_paged_attention(q.float(), kp.float(), vp.float(), bt,
                                  lengths, scale)
    err, rel, ok = agreement([(out, ref)], "bfloat16")
    log(f"families k1 {tag}: {nh} heads over {kvh} of {hd}, max_abs_err "
        f"{err:.3e}, vector-relative {rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"families k1 {tag} disagrees with its plain "
                         f"version")
    k1_time(torch, pa, tag, q, kp, vp, bt, lengths, lens, scale, peak,
            flush, record, err)
    slots = [(0, 512), (256, 512), (300, 300), (T, 0), (37, 512),
             (512, 200), (100, 512), (512, 500)]
    t0 = torch.tensor([t for t, _ in slots], dtype=torch.int32,
                      device="cuda")
    last = torch.tensor([t + n - 1 if n else -1 for t, n in slots],
                        dtype=torch.int32, device="cuda")
    q = torch.randn((S, 512, nh, hd), generator=gen, device="cuda").to(dt)
    out = rp.ragged_prefill_attention(q, kp, vp, bt, t0, last, scale)
    ref = rp._ref_ragged_prefill(q.float(), kp.float(), vp.float(), bt, t0,
                                 last, scale)
    err, rel, ok = agreement([(out[s, :n], ref[s, :n])
                              for s, (_, n) in enumerate(slots) if n],
                             "bfloat16")
    del ref
    log(f"families k2 {tag}: C=512, max_abs_err {err:.3e}, "
        f"vector-relative {rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"families k2 {tag} disagrees with its plain "
                         f"version")
    k2_time(torch, rp, tag, q, kp, vp, bt, t0, last, slots, scale, peak,
            flush, record, err)
    admit = [(0, 512, 0), (256, 512, 0), (300, 300, 0), (T, 0, 0),
             (700, 1, 1), (512, 200, 0), (900, 1, 1), (512, 500, 0)]
    decode = [(n - 1, 1, 1) for n in lens]
    for tick, C, ts in (("admit", 512, admit), ("decode", 1, decode)):
        last_l = [t + n - 1 if n else -1 for t, n, _ in ts]
        ss, sp, _ = ft.build_schedule(last_l, pg, n_slots=S)
        args = (bt, torch.tensor([t for t, _, _ in ts], dtype=torch.int32,
                                 device="cuda"),
                torch.tensor(last_l, dtype=torch.int32, device="cuda"),
                torch.tensor([d for _, _, d in ts], dtype=torch.int32,
                             device="cuda"),
                torch.from_numpy(ss).to("cuda"),
                torch.from_numpy(sp).to("cuda"), scale)
        q = torch.randn((S, C, nh, hd), generator=gen,
                        device="cuda").to(dt)
        out = ft.fused_tick_attention(q, kp, vp, *args)
        ref = ft._ref_fused_tick(q.float(), kp.float(), vp.float(),
                                 *args[:4], scale)
        rows = [1 if d else n for _, n, d in ts]
        err, rel, ok = agreement([(out[s, :n], ref[s, :n])
                                  for s, n in enumerate(rows) if n],
                                 "bfloat16")
        del ref
        log(f"families k3 {tick} {tag}: C={C}, max_abs_err {err:.3e}, "
            f"vector-relative {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"families k3 {tick} {tag} disagrees with its "
                             f"plain version")
        k3_time(torch, F, ft, pa, tick, tag, q, kp, vp, bt, args, ts, peak,
                flush, record, err)
    del flush, kp, vp, bt, q, out
    torch.cuda.empty_cache()


def phase_families(torch, np, card, peak, record, model_7b, serve_res):
    """GPT-2 345M (full depth) and Mixtral-8x7B's widths at 8 of 32
    layers in bf16 from seed 0, then the serve phase's Llama-2-7B with
    int8 weights: timed waves (``family_wave``) and their int8 gates
    (``int8_checks``), a profiled decode tick of each family in bf16 and
    int8, and K1-K3 alone at GPT-2's and Mixtral's heads."""
    import gc
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    fams = {name: (cls, full) for name, cls, _, full in family_models()}
    # --- GPT-2 345M: 8 slots x 1024 (its position table), bf16 and int8
    cls, cfg = fams["gpt2"]
    model = cls(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    L, V = cfg.num_layers, cfg.vocab_size
    prompts, warm = family_prompts(np, V)
    log(f"families gpt2: GPT-2 345M bf16 from seed 0, {L} layers, "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
        f"prompts {[len(p) for p in prompts]}, 32 new tokens each")
    paged = dict(max_cache_len=1024, cache_backend="paged")
    res = {}
    for tag, kw in (("gpt2 split", {}),
                    ("gpt2 fused", dict(serving_mode="fused")),
                    ("gpt2 int8 split", dict(weight_dtype="int8"))):
        res[tag] = family_wave(torch, np, card, tag, model, prompts, warm,
                               L, V, **paged, **kw)
    res["gpt2 int8-cache dense"] = family_wave(
        torch, np, card, "gpt2 int8-cache dense", model, prompts, warm, L,
        V, max_cache_len=1024, cache_backend="dense", cache_dtype="int8")
    int8_checks(torch, "gpt2", model, 1024, prompts[0],
                res["gpt2 int8 split"], res["gpt2 split"])
    for mode, kw in (("gpt2 bf16 split", {}),
                     ("gpt2 int8 split", dict(weight_dtype="int8"))):
        profile_decode(torch, np, ContinuousBatchingServer(
            model, max_slots=8, page_size=16, prefill_tokens_per_tick=512,
            **paged, **kw), cfg, card, mode)
        gc.collect()
        torch.cuda.empty_cache()
    family_kernel_times(torch, peak, record, "gpt2", cfg.num_heads,
                        cfg.num_heads, cfg.hidden_size // cfg.num_heads)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # --- Llama-2-7B (the serve phase's model and prompts), int8 weights
    cls, cfg = fams["llama"]
    if model_7b is None:
        model_7b = cls(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(0)          # the serve phase's prompts
    lens = rng.integers(128, 1025, size=8)
    prompts7 = [rng.integers(0, V, (int(n),)).astype(np.int32)
                for n in lens]
    warm7 = rng.integers(0, V, (40,)).astype(np.int32)
    seven = dict(max_cache_len=2048, cache_backend="paged")
    for tag, kw in (("llama-7b int8 split", {}),
                    ("llama-7b int8 fused", dict(serving_mode="fused"))):
        res[tag] = family_wave(torch, np, card, tag, model_7b, prompts7,
                               warm7, L, V, weight_dtype="int8", **seven,
                               **kw)
    bf16 = serve_res["split"][0] if serve_res else family_wave(
        torch, np, card, "llama-7b split", model_7b, prompts7, warm7, L, V,
        **seven)
    int8_checks(torch, "llama-7b", model_7b, 2048, prompts7[0],
                res["llama-7b int8 split"], bf16)
    del res["llama-7b int8 fused"]["int8_weights"]
    model_7b.reset_generate_cache()         # frees the int8 copy
    gc.collect()
    torch.cuda.empty_cache()
    # --- Mixtral-8x7B's widths at 8 of its 32 layers
    cls, cfg = fams["mixtral"]
    t_init = time.perf_counter()
    model = cls(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    L, V = cfg.num_layers, cfg.vocab_size
    prompts, warm = family_prompts(np, V)
    log(f"families mixtral: Mixtral-8x7B widths bf16 from seed 0 at {L} of "
        f"32 layers in {time.perf_counter() - t_init:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
        f"prompts {[len(p) for p in prompts]}, 32 new tokens each; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated "
        f"with the 7B model resident")
    for tag, kw in (("mixtral split", {}),
                    ("mixtral fused", dict(serving_mode="fused")),
                    ("mixtral int8 split", dict(weight_dtype="int8"))):
        res[tag] = family_wave(torch, np, card, tag, model, prompts, warm,
                               L, V, **paged, **kw)
    int8_checks(torch, "mixtral", model, 1024, prompts[0],
                res["mixtral int8 split"], res["mixtral split"])
    for mode, kw in (("mixtral bf16 split", {}),
                     ("mixtral int8 split", dict(weight_dtype="int8"))):
        profile_decode(torch, np, ContinuousBatchingServer(
            model, max_slots=8, page_size=16, prefill_tokens_per_tick=512,
            **paged, **kw), cfg, card, mode)
        gc.collect()
        torch.cuda.empty_cache()
    family_kernel_times(torch, peak, record, "mixtral", cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for tag, r in res.items():
        log(f"families summary {tag} [{card}]: {r['tok_s']:.1f} tok/s, TPOT "
            f"{r['decode_ms']:.2f} ms, TTFT median {r['ttft_med']:.1f} ms, "
            f"peak {r['peak_gib']:.2f} GiB, K1 {r['counts']['k1']}, K2 "
            f"{r['counts']['k2']}, K3 {r['counts']['k3']}")
    return model_7b


def near_ties(torch, np, model, tag, got, want, T):
    """The near-tie rule of two card runs ``got`` and ``want`` (int token
    arrays ``[B, T + N]``, ``want`` the yardstick): a row may differ only
    from a position where the yardstick's top-2 logit gap is within
    ``TOL["bfloat16"]`` of that row's max |logit| (the model's forward
    over the yardstick's tokens to there gives the logits). Logs each
    differing row's first position and gap; returns whether every row
    keeps the rule."""
    good = True
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not len(diff):
            continue
        p = int(diff[0])
        if p < T:
            log(f"{tag} row {b}: the prompt differs at {p}")
            good = False
            continue
        with torch.no_grad():
            ids = torch.from_numpy(want[b:b + 1, :p].astype(np.int64))
            row = model(ids.to(model.device))[0, -1].float()
        top = torch.topk(row, 2).values
        gap = float(top[0] - top[1])
        scale = float(row.abs().max())
        near = gap <= TOL["bfloat16"] * scale
        log(f"{tag} row {b}: first difference at new token {p - T} "
            f"(yardstick {int(want[b, p])}, run {int(got[b, p])}): top-2 "
            f"gap {gap:.5f} = {gap / scale:.5f} of max |logit| {scale:.3f}; "
            f"near-tie {near}")
        good &= near
    return good


def phase_decode_parity(torch, np):
    """gpt2_tiny, mixtral_tiny and llama_tiny in float32 (weights from
    seed 3; a weak draft from seed 4), on the card and on the CPU: beam
    search at K = 1 and 3 (``beam_generate``), FSM-constrained greedy and
    seeded sampled ``generate`` over a phrase trie, speculative decoding
    with a perfect and a weak draft, and 6 steps of ``scan_decode`` from
    a prefill. The card's tokens, scores (f32 within 1e-4), acceptance
    and ``scan_decode`` output and caches (within 1e-4) must equal the
    CPU's; the dense bundles launch no kernel, R2 once a sampled FSM
    draw (max_new_tokens + 1: its last step's pick moves the state).
    Then a ``BatchScheduler`` over the card's llama_tiny forward (last
    position's f32 logits): 6 one-row requests from 3 threads give the
    one-row results within 1e-4."""
    from paddle_tpu_torch.inference import phrases_to_fsm
    from paddle_tpu_torch.models import export_params, load_jax_params
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, (2, 9)).astype(np.int32)
    T, new, mcl = 9, 8, 32
    fsm = phrases_to_fsm([[10, 20, 30], [10, 25], [40, 41, 42, 43]], 256, 7)
    sample = dict(do_sample=True, temperature=1.5, seed=11)
    good = True
    for fam, cls, cfg, _ in family_models():
        runs = {}
        cpu_pair = (cls(cfg, device="cpu", seed=3),
                    cls(cfg, device="cpu", seed=4))
        card_pair = tuple(cls(cfg, device="cuda") for _ in range(2))
        for src, dst in zip(cpu_pair, card_pair):
            load_jax_params(dst, export_params(src))
        for dev, (model, weak) in (("cpu", cpu_pair), ("cuda", card_pair)):
            runs[dev] = decode_parity_run(torch, np, model, weak, ids, T,
                                          new, mcl, fsm, sample)
        del cpu_pair, card_pair
        cpu, card = runs["cpu"], runs["cuda"]
        for key in cpu["out"]:
            a, b = cpu["out"][key], card["out"][key]
            if a.dtype.kind == "f":
                err = float(np.abs(a - b).max())
                same = err <= 1e-4
                log(f"decode_parity {fam} {key}: card within {err:.2e} of "
                    f"the CPU's {same}")
            else:
                same = a.shape == b.shape and np.array_equal(a, b)
                log(f"decode_parity {fam} {key}: card equal to the CPU's "
                    f"{same}")
            good &= same
        n, draws = card["counts"], new + 1
        launched = n["r2_fill"] == draws and not any(
            v for k, v in n.items() if k != "r2_fill")
        log(f"decode_parity {fam}: card launches {n}; R2 = the sampled "
            f"FSM's {draws} draws, nothing else: {launched}; CPU launches "
            f"{ {k: v for k, v in cpu['counts'].items() if v} }")
        good &= launched and not any(cpu["counts"].values())
    good &= decode_parity_scheduler(torch, np)
    torch.cuda.empty_cache()
    if not good:
        raise SystemExit("decode_parity: the card and the CPU disagree, or "
                         "a run's launches are not its path's")


def decode_parity_run(torch, np, model, weak, ids, T, new, mcl, fsm,
                      sample):
    """One device's decode_parity outputs: {"out": {name: array},
    "counts": launches over the runs}."""
    from paddle_tpu_torch.inference import (beam_generate, scan_decode,
                                            speculative_generate)
    out = {}
    zero_counts()
    bundle = model._decode_bundle(mcl)
    for K in (1, 3):
        last, caches = model._run_prefill(bundle, ids)
        toks, scores = beam_generate(bundle[1], bundle[2], bundle[3], caches,
                                     last, T, new, K)
        out[f"beam K={K}"] = toks.cpu().numpy()
        out[f"beam K={K} scores"] = scores.cpu().numpy()
    out["fsm greedy"] = model.generate(
        ids, max_new_tokens=new, max_cache_len=mcl, fsm=fsm,
        eos_token_id=7).cpu().numpy()
    out["fsm sampled"] = model.generate(
        ids, max_new_tokens=new, max_cache_len=mcl, fsm=fsm, eos_token_id=7,
        **sample).cpu().numpy()
    for name, draft in (("perfect", model), ("weak", weak)):
        toks, st = speculative_generate(model, draft, ids[:1],
                                        max_new_tokens=new, gamma=3,
                                        max_cache_len=mcl, return_stats=True)
        out[f"speculative {name}"] = toks.cpu().numpy()
        out[f"speculative {name} accepted"] = np.asarray(
            st["accepted_per_round"])
    last, caches = model._run_prefill(bundle, ids)
    x0 = bundle[1](torch.tensor([3, 11], dtype=torch.int32,
                                device=model.device), T)
    x, caches = scan_decode(bundle[2], x0, caches, T, 6)
    out["scan_decode out"] = x.float().cpu().numpy()
    out["scan_decode k cache"] = caches["k"].float().cpu().numpy()
    return {"out": out, "counts": read_counts()}


def decode_parity_scheduler(torch, np):
    """The scheduler over llama_tiny's forward on the card: every request
    within 1e-4 of its one-row run, no batch above max_batch_size."""
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.inference import BatchScheduler
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    model = LlamaForCausalLM(llama_tiny(), device="cuda", seed=3)
    rows = []

    def runner(stacked):
        rows.append(stacked[0].shape[0])
        with torch.no_grad():
            x = torch.from_numpy(stacked[0].astype(np.int64)).cuda()
            return [model(x)[:, -1].float().cpu().numpy()]

    reqs = [np.random.default_rng(i).integers(0, 256, (1, 9))
            for i in range(6)]
    sched = BatchScheduler(runner, max_batch_size=4, max_delay_ms=50)
    with ThreadPoolExecutor(max_workers=3) as ex:
        got = list(ex.map(lambda r: sched.submit(r).result(timeout=120)[0],
                          reqs))
    sched.close()
    batched = list(rows)
    err = max(float(np.abs(g - runner([r])[0]).max())
              for g, r in zip(got, reqs))
    good = err <= 1e-4 and max(batched) <= 4 and sum(batched) == 6
    log(f"decode_parity scheduler: batches of {batched} rows, every "
        f"request within {err:.2e} of its one-row run: {good}")
    return good


def fsm_phrases(np, vocab, eos):
    """8 phrases of 4-12 tokens from seed 13, of ids above ``eos``."""
    rng = np.random.default_rng(13)
    return [[int(t) for t in rng.integers(eos + 1, vocab, (int(n),))]
            for n in rng.integers(4, 13, size=8)]


def phase_decoding(torch, np, card, model):
    """Beam, FSM-constrained and speculative decoding on the serve phase's
    Llama-2-7B (bf16, seed 0; built here if that phase did not run).

    Beam: ``generate(num_beams=4)`` over 2 prompts of 512 tokens, 32 new
    each; ``beam_generate`` at K = 1 against ``generate()`` greedy (the
    near-tie rule, ``near_ties``). FSM: greedy and seeded sampled
    ``generate(fsm=)`` over ``phrases_to_fsm`` of 8 phrases of 4-12
    tokens, 16 new tokens: every row a phrase and an eos tail.
    Speculative: gamma 4, 64 new tokens, one 512-token prompt, a weak
    draft (Llama-2-7B's widths at 2 layers, seed 1) and a perfect one
    (the target): tokens against ``generate()`` greedy under the near-tie
    rule; rounds, acceptance, tokens a target forward and ms a token
    reported beside ``generate()``'s. The counters are zeroed before
    each timed run and read after it: the dense bundles launch no
    kernel, the sampled FSM R2 once a draw (16 + 1)."""
    from paddle_tpu_torch.inference import (beam_generate, phrases_to_fsm,
                                            speculative_generate)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    cfg = llama2_7b()
    if model is None:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
    V, T, new, eos = cfg.vocab_size, 512, 32, 2
    prompts = np.random.default_rng(9).integers(0, V, (2, T)).astype(
        np.int32)
    checks, launched = {}, {}

    def timed(fn, tag=None):
        """fn's result and ms; with a tag, its launches kept under it."""
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if tag is not None:
            launched[tag] = {k: v for k, v in read_counts().items() if v}
        return out, (time.perf_counter() - t0) * 1e3

    model.generate(prompts, max_new_tokens=2)        # warm, untimed
    # --- beam search
    greedy, g_ms = timed(lambda: model.generate(
        prompts, max_new_tokens=new).cpu().numpy(), "greedy")
    beam4, b4_ms = timed(lambda: model.generate(
        prompts, max_new_tokens=new, num_beams=4).cpu().numpy(), "beam 4")
    bundle = model._decode_bundle(T + new)

    def beam1():
        last, caches = model._run_prefill(bundle, prompts)
        toks, scores = beam_generate(bundle[1], bundle[2], bundle[3], caches,
                                     last, T, new, 1)
        return np.concatenate([prompts, toks.cpu().numpy()], 1), scores

    (b1, b1_scores), b1_ms = timed(beam1, "beam 1")
    log(f"decoding beam [{card}]: 2 x {T} prompts, {new} new tokens: "
        f"greedy generate {g_ms:.1f} ms ({g_ms / new:.2f} ms a token), "
        f"num_beams=4 {b4_ms:.1f} ms ({b4_ms / new:.2f} ms a token), "
        f"beam_generate K=1 {b1_ms:.1f} ms; beam 4 tokens "
        f"{beam4[:, T:T + 8].tolist()}...; K=1 scores "
        f"{b1_scores.float().cpu().numpy().ravel().tolist()}")
    checks["beam 4: [2, 544] tokens in the vocabulary"] = \
        beam4.shape == (2, T + new) and bool((beam4 >= 0).all()
                                             and (beam4 < V).all())
    checks["beam K=1 = greedy generate, near-ties apart"] = near_ties(
        torch, np, model, "decoding beam K=1", b1, greedy, T)
    # --- FSM-constrained
    phrases = fsm_phrases(np, V, eos)
    fsm = phrases_to_fsm(phrases, V, eos)
    for tag, kw in (("greedy", {}),
                    ("sampled", dict(do_sample=True, temperature=0.8,
                                     seed=5))):
        out, ms = timed(lambda: model.generate(
            prompts, max_new_tokens=16, fsm=fsm, eos_token_id=eos,
            **kw).cpu().numpy(), f"fsm {tag}")
        rows = out[:, T:].tolist()
        ok = all(any(r == ph + [eos] * (16 - len(ph)) for ph in phrases)
                 for r in rows)
        log(f"decoding fsm {tag} [{card}]: 2 x {T} prompts, 16 new tokens "
            f"in {ms:.1f} ms ({ms / 16:.2f} ms a token); rows {rows}; "
            f"each a phrase + eos tail: {ok}")
        checks[f"fsm {tag}: every row a phrase and an eos tail"] = ok
    # --- speculative
    prompt = prompts[:1]
    n_spec, gamma = 64, 4
    mcl = T + n_spec + gamma + 1
    want, gen_ms = timed(lambda: model.generate(
        prompt, max_new_tokens=n_spec, max_cache_len=mcl).cpu().numpy())
    _, pre_ms = timed(lambda: model.generate(
        prompt, max_new_tokens=1, max_cache_len=mcl))
    tpot = (gen_ms - pre_ms) / (n_spec - 1)
    log(f"decoding speculative yardstick [{card}]: generate() greedy "
        f"{n_spec} tokens in {gen_ms:.1f} ms ({gen_ms / n_spec:.2f} ms a "
        f"token), TPOT {tpot:.2f} ms (64 tokens less 1, over 63)")
    weak = LlamaForCausalLM(llama2_7b(num_layers=2), device="cuda",
                            dtype=torch.bfloat16, seed=1)
    for tag, draft in (("weak", weak), ("perfect", model)):
        (toks, st), ms = timed(lambda: speculative_generate(
            model, draft, prompt, max_new_tokens=n_spec, gamma=gamma,
            max_cache_len=mcl, return_stats=True), f"speculative {tag}")
        got = toks.cpu().numpy()
        log(f"decoding speculative {tag} draft [{card}]: {n_spec} tokens in "
            f"{ms:.1f} ms ({ms / n_spec:.2f} ms a token against generate()'s "
            f"{gen_ms / n_spec:.2f}); {st['rounds']} rounds, mean accepted "
            f"{st['mean_accepted']:.3f} of {gamma}, "
            f"{st['tokens_per_target_forward']:.3f} tokens a target forward; "
            f"accepted per round {st['accepted_per_round']}")
        checks[f"speculative {tag}: = generate() greedy, near-ties apart"] \
            = near_ties(torch, np, model, f"decoding speculative {tag}",
                        got, want, T)
    del weak
    model.reset_generate_cache()
    torch.cuda.empty_cache()
    want = {tag: {"r2_fill": 17} if tag == "fsm sampled" else {}
            for tag in launched}
    log(f"decoding launches: {launched}")
    checks["launches: none on the dense bundles, R2 17 on the sampled "
           "FSM"] = launched == want
    log(f"decoding checks: {checks}")
    for name, ok in checks.items():
        if not ok:
            raise SystemExit(f"decoding: check failed: {name}")
    return model


def fused_gelu(torch):
    """A K7 module for the deploy phase: ``gelu(x @ w + b)`` through the
    incubate entry, bf16 at GPT-2 345M's FFN widths (1024 -> 4096), w
    from seed 0 at 0.03 scale."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    class FusedGelu(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator(device="cuda").manual_seed(0)
            w = torch.randn(1024, 4096, device="cuda", generator=g) * 0.03
            self.w = torch.nn.Parameter(w.to(torch.bfloat16))
            self.b = torch.nn.Parameter(torch.zeros(
                4096, device="cuda", dtype=torch.bfloat16))

        def forward(self, x):
            return IF.fused_linear_activation(x, self.w, self.b,
                                              activation="gelu")

    return FusedGelu()


@contextlib.contextmanager
def archive_io_times():
    """{"save": [s], "load": [s]}: the seconds of every archive write
    (``torch.export.save``) and read (``torch.export.load`` with its move
    to the device) under the block, through the inference modules'
    ``_save_program`` / ``_load_program``; restored after the block."""
    from paddle_tpu_torch.inference import deploy_decode as dd
    from paddle_tpu_torch.inference import export as ex
    out = {"save": [], "load": []}
    save, load = ex._save_program, ex._load_program

    def timing(fn, key):
        def run(*a):
            t0 = time.perf_counter()
            res = fn(*a)
            out[key].append(round(time.perf_counter() - t0, 2))
            return res
        return run

    for mod in (ex, dd):
        mod._save_program = timing(save, "save")
        mod._load_program = timing(load, "load")
    try:
        yield out
    finally:
        for mod in (ex, dd):
            mod._save_program, mod._load_program = save, load


# the GPT-2 345M layers deploy's export_decode traces (of 24: the
# export's time follows the depth, and the whole script keeps within its
# budget; the predictor exports all 24)
DECODE_LAYERS = 4


def phase_deploy(torch, np, card, record):
    """The deployment archives on the card, written under a temporary
    directory the phase removes.

    Tiny, f32 (seed 3): ``export_layer`` of llama_tiny's forward (a
    dynamic batch, run at 3 rows), of its ``to_int8_inference`` copy and
    of a bf16 fused linear (``fused_gelu``, 64 rows): each archive's output
    equals the eager output on the card, and a run launches K4a once a
    layer, K5a twice a layer and once more, K6 (q + k) once a layer, K8
    once a projection and the head, K7 once. ``export_decode`` of
    llama_tiny (2 x 9, 8 new): tokens equal the card's ``generate()``.

    GPT-2 345M (full width, bf16, seed 0): ``export_decode`` of its first
    ``DECODE_LAYERS`` layers at 4 x 256 prompt tokens, 32 new (tokens
    against ``generate()`` under the near-tie rule); at full depth
    ``export_layer`` of the forward at a dynamic batch
    of 64-token rows, run through ``create_predictor`` (K4a 24 times a
    run, logits within TOL of the eager forward's), and a
    ``BatchScheduler`` over that ``Predictor``: 16 one-row requests from 4
    threads, ``max_batch_size=8`` (no batch above 8 rows, each result
    within TOL of a one-row run). Both logit gates scale TOL by the
    eager logits' largest magnitude (TOL is sized for outputs near 1; a
    batched GEMM's bf16 rounding follows its row count). Export s,
    archive MB, load s and ms a run printed."""
    import gc
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt2_345m, llama_tiny)
    from paddle_tpu_torch.quantization import to_int8_inference
    from paddle_tpu_torch.static import InputSpec
    root = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    checks = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def mb(*paths):
        return sum(os.path.getsize(p) for p in paths) / 2 ** 20

    try:
        # --- tiny archives on the card: the custom ops launch the kernels
        tiny = LlamaForCausalLM(llama_tiny(), device="cuda", seed=3)
        L = tiny.cfg.num_layers
        ids = np.random.default_rng(3).integers(0, 256, (3, 16)).astype(
            np.int32)
        fused = fused_gelu(torch)
        x = torch.randn(64, 1024, device="cuda").to(torch.bfloat16)
        cases = (
            ("llama_tiny", tiny, [InputSpec([-1, 16], "int32", "ids")],
             ids, {"k4_fwd": L, "k5_fwd": 2 * L + 1, "k6_qk": L}),
            ("llama_tiny int8", to_int8_inference(tiny),
             [InputSpec([3, 16], "int32", "ids")], ids,
             {"k4_fwd": L, "k5_fwd": 2 * L + 1, "k6_qk": L,
              "k8": 7 * L + 1}),
            ("fused linear", fused, [InputSpec([-1, 1024], "bfloat16",
                                               "x")], x, {"k7": 1}))
        for tag, layer, spec, feed, want in cases:
            prefix = os.path.join(root, tag.replace(" ", "_"))
            inference.export_layer(prefix, layer, spec)
            prog, _, _ = inference.load_exported(prefix)
            zero_counts()
            got = prog(feed)
            torch.cuda.synchronize()
            n = read_counts()
            with torch.no_grad():
                eager = layer(torch.as_tensor(feed).cuda())
            launched = {k: v for k, v in n.items() if v}
            ok = torch.equal(got, eager) and launched == want
            log(f"deploy {tag}: archive output equal to the eager card "
                f"output {torch.equal(got, eager)}; a run's launches "
                f"{launched} (want {want}): {ok}")
            checks[f"{tag}: archive = eager on the card, launches {want}"] \
                = ok
            for kname, k in (("flash_attention_fwd", "k4_fwd"),
                             ("rms_norm_fwd", "k5_fwd"), ("rope", "k6_qk"),
                             ("quant_matmul", "k8"),
                             ("gemm_epilogue", "k7")):
                if k in want:
                    record[kname]["export_launches"] = n[k]
        prefix = os.path.join(root, "tiny_gen")
        inference.export_decode(prefix, tiny, prompt_len=9, max_new_tokens=8,
                                batch=2)
        got = inference.load_decode(prefix).generate(ids[:2, :9])
        want = tiny.generate(ids[:2, :9], max_new_tokens=8).cpu().numpy()
        checks["llama_tiny export_decode = the card's generate()"] = \
            np.array_equal(got, want)
        log(f"deploy llama_tiny export_decode: tokens equal the card's "
            f"generate() {np.array_equal(got, want)}")
        del tiny, fused
        # --- GPT-2 345M: its widths at DECODE_LAYERS layers for
        # export_decode (the trace's time follows the depth), full depth
        # for the predictor
        cfg = gpt2_345m()
        dec = GPTForCausalLM(
            dataclasses.replace(cfg, num_layers=DECODE_LAYERS),
            device="cuda", dtype=torch.bfloat16, seed=0)
        B, T, new = 4, 256, 32
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, T)).astype(np.int32)
        prefix = os.path.join(root, "gpt2_gen")
        with archive_io_times() as io_s:
            paths, export_s = timed(lambda: inference.export_decode(
                prefix, dec, prompt_len=T, max_new_tokens=new, batch=B))
            gen, load_s = timed(lambda: inference.load_decode(prefix))
        runs = []
        for _ in range(2):
            zero_counts()
            got, run_s = timed(lambda: gen.generate(prompts))
            runs.append(run_s * 1e3)
        n = {k: v for k, v in read_counts().items() if v}
        want, gen_s = timed(lambda: dec.generate(
            prompts, max_new_tokens=new).cpu().numpy())
        log(f"deploy gpt2 export_decode [{card}]: {DECODE_LAYERS} of "
            f"{cfg.num_layers} layers, {B} x {T} prompts, {new} "
            f"new: export {export_s:.2f} s ({sum(io_s['save']):.2f} of it "
            f"torch.export.save, {io_s['save']}), archives "
            f"{mb(*paths):.1f} MB (prefill {mb(paths[0]):.1f}, decode "
            f"{mb(paths[1]):.1f}), load {load_s:.2f} s ("
            f"{sum(io_s['load']):.2f} of it torch.export.load and the move, "
            f"{io_s['load']}), a run {runs[0]:.1f} then {runs[1]:.1f} ms "
            f"({runs[1] / new:.2f} ms a token; generate() {gen_s * 1e3:.1f} "
            f"ms); a run's launches {n} (the dense bundle: plain torch)")
        checks["gpt2 export_decode = generate(), near-ties apart"] = \
            near_ties(torch, np, dec, "deploy gpt2 export_decode", got,
                      want, T)
        del gen, dec
        for p in paths:
            os.remove(p)
        gpt = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
        prefix = os.path.join(root, "gpt2_fwd")
        S = 64
        with archive_io_times() as io_s:
            _, export_s = timed(lambda: inference.export_layer(
                prefix, gpt, [InputSpec([-1, S], "int32", "ids")]))
            pred, load_s = timed(lambda: inference.create_predictor(
                inference.Config(prefix)))
        x = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                              (2, S)).astype(np.int32)
        runs = []
        for _ in range(3):
            zero_counts()
            out, run_s = timed(lambda: pred.run([x])[0])
            runs.append(run_s * 1e3)
            n = read_counts()
        with torch.no_grad():
            eager = gpt(torch.from_numpy(x).cuda()).float().cpu().numpy()
        err = float(np.abs(out - eager).max())
        ok = n["k4_fwd"] == cfg.num_layers and \
            err <= TOL["bfloat16"] * max(1.0, float(np.abs(eager).max()))
        log(f"deploy gpt2 predictor [{card}]: export {export_s:.2f} s "
            f"({sum(io_s['save']):.2f} saving), archive "
            f"{mb(prefix + '.pdmodel'):.1f} MB, load {load_s:.2f} s "
            f"({sum(io_s['load']):.2f} in torch.export.load), "
            f"a run of 2 x {S} {runs[0]:.1f} / {runs[1]:.1f} / "
            f"{runs[2]:.1f} ms; K4a {n['k4_fwd']} a run; logits within "
            f"{err:.3e} of the eager forward's (bitwise "
            f"{np.array_equal(out, eager)}): {ok}")
        checks["gpt2 predictor: K4a 24 a run, logits within TOL"] = ok
        record["flash_attention_fwd"]["export_launches_gpt2"] = n["k4_fwd"]
        rows = []

        def runner(stacked):
            rows.append(stacked[0].shape[0])
            return pred.run(stacked)

        sched = inference.BatchScheduler(runner, max_batch_size=8,
                                         max_delay_ms=20)
        reqs = [np.random.default_rng(10 + i).integers(
            0, cfg.vocab_size, (1, S)).astype(np.int32) for i in range(16)]

        def client(part):
            futs = [sched.submit(r) for r in part]
            return [f.result(timeout=300)[0] for f in futs]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as ex:
            res = [o for part in ex.map(client, [reqs[i::4] for i in
                                                range(4)]) for o in part]
        sched_s = time.perf_counter() - t0
        sched.close()
        order = [r for i in range(4) for r in reqs[i::4]]
        errs = [float(np.abs(o - pred.run([r])[0]).max())
                for o, r in zip(res, order)]
        ok = max(rows) <= 8 and sum(rows) == 16 and max(errs) <= TOL[
            "bfloat16"] * max(1.0, float(np.abs(eager).max()))
        log(f"deploy gpt2 scheduler [{card}]: 16 one-row requests from 4 "
            f"threads in {sched_s * 1e3:.1f} ms, batches of {rows} rows; "
            f"each within {max(errs):.3e} of its one-row run: {ok}")
        checks["gpt2 scheduler: batches <= 8 rows, one-row results"] = ok
        del pred, gpt
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"deploy checks: {checks}")
    for name, ok in checks.items():
        if not ok:
            raise SystemExit(f"deploy: check failed: {name}")


# ------------------------------------------------------------ tensor_api

# the API's cost a dispatched op (api_cost_us, us) of the tree before the
# static recorder's hook was added in dispatch: the least and the most of
# its 36 readings beside this tree's (--parent) in two calls on an H100
# 80GB HBM3 at 700 W
API_US_SPREAD = (2.048, 4.497)


def api_cost_us(torch, add, a, b, ta, tb):
    """The API's cost a dispatched op, us: ``add(a, b)`` less
    ``torch.add(ta, tb)`` in 40 alternating batches of 250, the median
    difference (a load that comes and goes lands on both sides alike),
    the least of five such medians (the host's noise only ever adds)."""
    def median():
        diffs = []
        for _ in range(40):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(250):
                add(a, b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(250):
                torch.add(ta, tb)
            torch.cuda.synchronize()
            diffs.append(((t1 - t0) - (time.perf_counter() - t1)) / 250)
        return sorted(diffs)[len(diffs) // 2] * 1e6
    return min(median() for _ in range(5))


def per_op_us(torch, fn, a, b, n_ops=10000):
    """us a call of ``fn(a, b)`` over ``n_ops`` calls in a row (after 100
    to warm up)."""
    for _ in range(100):
        fn(a, b)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_ops):
        fn(a, b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n_ops * 1e6

# the block's widths: llama_350m's (models.llama.llama_350m)
BLOCK_WIDTHS = {"hidden": 1024, "heads": 16, "inter": 2816, "B": 8,
                "S": 1024}


def block_weights(np, hidden, inter, seed=0):
    """The block's weights in f32 from ``seed``: the projections
    N(0, 0.02^2), the two norm scales ones."""
    rng = np.random.default_rng(seed)

    def proj(a, b):
        return (rng.standard_normal((a, b)) * 0.02).astype(np.float32)

    return {"ln1": np.ones(hidden, np.float32),
            "wq": proj(hidden, hidden), "wk": proj(hidden, hidden),
            "wv": proj(hidden, hidden), "wo": proj(hidden, hidden),
            "ln2": np.ones(hidden, np.float32),
            "wg": proj(hidden, inter), "wu": proj(hidden, inter),
            "wd": proj(inter, hidden)}


def api_block(m, w, x, heads):
    """One Llama block through the paddle API of ``m`` (the port, or the
    JAX package in the CPU test): ``w`` its weights as Tensors, ``x``
    ``[B, S, hidden]``. Returns the mean of the block's output."""
    F = m.nn.functional
    B, S, H = x.shape
    d = H // heads
    h = F.rms_norm(x, w["ln1"])
    q = m.matmul(h, w["wq"]).reshape([B, S, heads, d])
    k = m.matmul(h, w["wk"]).reshape([B, S, heads, d])
    v = m.matmul(h, w["wv"]).reshape([B, S, heads, d])
    a = F.flash_attention(q, k, v, causal=True)
    if isinstance(a, tuple):            # the JAX package's (out, None)
        a = a[0]
    x = x + m.matmul(a.reshape([B, S, H]), w["wo"])
    h = F.rms_norm(x, w["ln2"])
    g = m.matmul(h, w["wg"])
    u = m.matmul(h, w["wu"])
    x = x + m.matmul(F.silu(g) * u, w["wd"])
    return m.mean(x)


# the static stack's parameters, in the block's order, and their shapes
STACK_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd")


def stack_shapes(hidden, inter):
    return {"ln1": [hidden], "wq": [hidden, hidden], "wk": [hidden, hidden],
            "wv": [hidden, hidden], "wo": [hidden, hidden],
            "ln2": [hidden], "wg": [hidden, inter], "wu": [hidden, inter],
            "wd": [inter, hidden]}


def stack_init(np, hidden, inter, layers, seed=0):
    """The static stack's weights as f32 arrays: block i is
    ``block_weights`` of seed + i."""
    return [block_weights(np, hidden, inter, seed=seed + i)
            for i in range(layers)]


def static_block(m, w, x, heads):
    """``api_block``'s Llama block, its output (not its mean), written so
    that the reference's static API records it too: every reshape takes
    ``shape=`` by keyword (its Executor traces a positional shape and
    fails)."""
    F = m.nn.functional
    B, S, H = x.shape
    d = H // heads
    h = F.rms_norm(x, w["ln1"])
    q = m.reshape(m.matmul(h, w["wq"]), shape=[B, S, heads, d])
    k = m.reshape(m.matmul(h, w["wk"]), shape=[B, S, heads, d])
    v = m.reshape(m.matmul(h, w["wv"]), shape=[B, S, heads, d])
    a = F.flash_attention(q, k, v, causal=True)
    if isinstance(a, tuple):            # the JAX package's (out, None)
        a = a[0]
    x = x + m.matmul(m.reshape(a, shape=[B, S, H]), w["wo"])
    h = F.rms_norm(x, w["ln2"])
    g = m.matmul(h, w["wg"])
    u = m.matmul(h, w["wu"])
    return x + m.matmul(F.silu(g) * u, w["wd"])


def static_stack(m, B, S, H, heads, inter, layers, dtype, init, train=True):
    """``layers`` static blocks under ``m.static.program_guard`` from
    ``static.data("x", [B, S, H], dtype)``, the loss the mean of the last
    block's output. Each block's weights come from
    ``static.create_parameter`` (named ``stack{i}_{name}``): ``init``'s
    arrays (``stack_init``) through ``Assign``, or, with ``init`` None,
    N(0, 0.02^2) projections and ones for the norms. ``train``:
    ``AdamW(1e-4).minimize(loss)``; else ``append_backward(loss)``.
    Returns (main, startup, x, loss, [(param, grad)] or None)."""
    st, I = m.static, m.nn.initializer
    main, startup = st.Program(), st.Program()
    shapes = stack_shapes(H, inter)
    with st.program_guard(main, startup):
        x = st.data("x", [B, S, H], dtype)
        h = x
        for i in range(layers):
            w = {}
            for k in STACK_PARAMS:
                if init is not None:
                    ini = I.Assign(init[i][k])
                elif k.startswith("ln"):
                    ini = I.Constant(1.0)
                else:
                    ini = I.Normal(0.0, 0.02)
                w[k] = st.create_parameter(shapes[k], dtype,
                                           name=f"stack{i}_{k}",
                                           default_initializer=ini)
            h = static_block(m, w, h, heads)
        loss = m.mean(h)
        grads = None
        if train:
            m.optimizer.AdamW(1e-4).minimize(loss)
        else:
            grads = st.append_backward(loss)
    return main, startup, x, loss, grads


def eager_stack(pt, torch, weights, x, heads, steps, device="cuda"):
    """The static stack run eagerly through the port's flat API:
    ``steps`` steps of ``AdamW(1e-4)`` over the blocks' weights
    (``weights``: a dict of arrays or tensors a block). Returns each
    step's loss (a 0-d torch tensor), taken before its update."""
    from paddle_tpu_torch.core.tensor import wrap
    leaves = [{k: torch.nn.Parameter(torch.as_tensor(v).to(device).clone())
               for k, v in w.items()} for w in weights]
    opt = pt.optimizer.AdamW(1e-4, parameters=[
        p for w in leaves for p in w.values()])
    px = pt.to_tensor(x, place=device) if not torch.is_tensor(x) \
        else pt.Tensor(x)
    losses = []
    for _ in range(steps):
        h = px
        for w in leaves:
            h = static_block(pt, {k: wrap(v) for k, v in w.items()}, h,
                             heads)
        loss = pt.mean(h)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.value.detach())
    return losses


def direct_block(torch, w, x, heads):
    """The same block written in torch over the kernel wrappers."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm
    B, S, H = x.shape
    d = H // heads
    h = rms_norm(x, w["ln1"], 1e-6)
    q = torch.matmul(h, w["wq"]).reshape(B, S, heads, d)
    k = torch.matmul(h, w["wk"]).reshape(B, S, heads, d)
    v = torch.matmul(h, w["wv"]).reshape(B, S, heads, d)
    a = flash_attention(q, k, v, causal=True)
    x = x + torch.matmul(a.reshape(B, S, H), w["wo"])
    h = rms_norm(x, w["ln2"], 1e-6)
    g = torch.matmul(h, w["wg"])
    u = torch.matmul(h, w["wu"])
    x = x + torch.matmul(torch.nn.functional.silu(g) * u, w["wd"])
    return torch.mean(x)


def optable_leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for e in x for leaf in optable_leaves(e)]
    return [x]


def optable_row(pt, np, case, np_inputs, weights):
    """One row on the default place: (outputs as numpy, their dtype
    names, each input's gradient as numpy or None) — gradients of
    ``sum(out * w)`` when ``weights`` is given."""
    from paddle_tpu_torch.core.dtype import dtype_name
    tensors = [pt.to_tensor(v, stop_gradient=not (
        weights is not None and np.issubdtype(np.asarray(v).dtype,
                                              np.floating)))
               for v in np_inputs]
    op = getattr(pt, case.name)
    out = case.call(op, tensors, case.attrs) if case.call is not None \
        else op(*tensors, **case.attrs)
    outs = optable_leaves(out)
    vals = [o.numpy() if isinstance(o, pt.Tensor) else np.asarray(o)
            for o in outs]
    names = [dtype_name(o.dtype) if isinstance(o, pt.Tensor)
             else type(o).__name__ for o in outs]
    grads = None
    if weights is not None:
        loss = None
        for o, w in zip(outs, weights):
            if w is not None and isinstance(o, pt.Tensor):
                part = (o * pt.to_tensor(w, place=o.value.device)).sum()
                loss = part if loss is None else loss + part
        if loss is not None:
            loss.backward()
        grads = [None if t.grad is None else t.grad.numpy()
                 for t in tensors]
    return vals, names, grads


def optable_close(np, got, want, atol, rtol):
    """(within atol / rtol — exact for bool and integers —, max |error|)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return False, float("inf")
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        same = bool(np.array_equal(got.astype(want.dtype), want))
        return same, 0.0 if same else float("inf")
    kind = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(want) \
        else np.float64
    g, w = got.astype(kind), want.astype(kind)
    err = float(np.nanmax(np.abs(g - w))) if g.size else 0.0
    return bool(np.allclose(g, w, atol=atol, rtol=rtol, equal_nan=True)), err


def tensor_api_table(torch, np, pt):
    """Part (a): every optable row on the card, against numpy and the
    CPU, values, dtypes and gradients. Returns (rows, grad rows, the
    largest card-CPU error, failures)."""
    from paddle_tpu_torch.ops.optable import TABLE
    fails, n_grad, worst = [], 0, 0.0
    for case in TABLE:
        np_inputs = [gen() for gen in case.inputs.values()]
        ref = optable_leaves(case.ref(*np_inputs) if case.inputs
                             else case.ref())
        floats_in = any(np.issubdtype(np.asarray(v).dtype, np.floating)
                        for v in np_inputs)
        weights = None
        if floats_in and any(np.issubdtype(np.asarray(r).dtype,
                                           np.floating) for r in ref):
            rng = np.random.RandomState(0)
            weights = [rng.uniform(0.5, 1.5, np.shape(r)).astype(np.float32)
                       if np.issubdtype(np.asarray(r).dtype, np.floating)
                       else None for r in ref]
            n_grad += 1
        atol, rtol = case.atol, case.rtol
        try:
            pt.set_device("gpu")
            card = optable_row(pt, np, case, np_inputs, weights)
            pt.set_device("cpu")
            cpu = optable_row(pt, np, case, np_inputs, weights)
        except Exception as e:           # noqa: BLE001 — reported below
            fails.append(f"{case.case_id}: {type(e).__name__}: {e}")
            continue
        if card[1] != cpu[1]:
            fails.append(f"{case.case_id}: dtypes {card[1]} vs {cpu[1]}")
        if len(card[0]) != len(ref):
            fails.append(f"{case.case_id}: {len(card[0])} outputs, "
                         f"numpy {len(ref)}")
            continue
        for i, (c, h, r) in enumerate(zip(card[0], cpu[0], ref)):
            ok_r, _ = optable_close(np, c, r, atol, rtol)
            ok_c, err = optable_close(np, c, h, atol, rtol)
            worst = max(worst, err)
            if not (ok_r and ok_c):
                fails.append(f"{case.case_id} output {i}: numpy {ok_r}, "
                             f"cpu {ok_c} (max |card - cpu| {err:.3g})")
        if weights is not None:
            gatol = max(atol, 1e-5)
            for i, (c, h) in enumerate(zip(card[2], cpu[2])):
                if (c is None) != (h is None):
                    fails.append(f"{case.case_id} grad {i}: card "
                                 f"{c is None}, cpu {h is None}")
                elif c is not None:
                    ok, err = optable_close(np, c, h, gatol, rtol)
                    worst = max(worst, err)
                    if not ok:
                        fails.append(f"{case.case_id} grad {i}: max "
                                     f"|card - cpu| {err:.3g}")
    return len(TABLE), n_grad, worst, fails


def phase_tensor_api(torch, np, card, record, parent=None):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as tdevice
    t0 = time.perf_counter()
    try:
        rows, n_grad, worst, fails = tensor_api_table(torch, np, pt)
    finally:
        tdevice._default[0] = None
    log(f"tensor_api table: {rows} rows on the card against numpy and the "
        f"CPU, {n_grad} with gradients; largest |card - CPU| {worst:.3g}; "
        f"{time.perf_counter() - t0:.1f} s")
    for f in fails:
        log(f"  tensor_api table FAIL {f}")
    # (b) the block at llama_350m's widths
    bw = BLOCK_WIDTHS
    H, heads, B, S = bw["hidden"], bw["heads"], bw["B"], bw["S"]
    wn = block_weights(np, H, bw["inter"], seed=0)
    xn = np.random.default_rng(1).standard_normal((B, S, H)).astype(
        np.float32)
    pw = {k: pt.to_tensor(v, dtype="bfloat16", place="gpu",
                          stop_gradient=False) for k, v in wn.items()}
    px = pt.to_tensor(xn, dtype="bfloat16", place="gpu")
    tw = {k: torch.tensor(v).to("cuda", torch.bfloat16).requires_grad_()
          for k, v in wn.items()}
    tx = torch.tensor(xn).to("cuda", torch.bfloat16)

    def api_step():
        loss = api_block(pt, pw, px, heads)
        loss.backward()
        return loss

    def direct_step():
        loss = direct_block(torch, tw, tx, heads)
        loss.backward()
        return loss

    for _ in range(2):                   # warm-up (cuBLAS, the kernels)
        api_step()
        direct_step()
    for w in pw.values():
        w.clear_grad()
    for w in tw.values():
        w.grad = None
    torch.cuda.synchronize()
    zero_counts()
    la = api_step()
    torch.cuda.synchronize()
    counts = read_counts()
    ld = direct_step()
    torch.cuda.synchronize()
    same = {"loss": torch.equal(la.value, ld.detach())}
    for k in wn:
        same[k] = torch.equal(pw[k].grad.value, tw[k].grad)
    finite = bool(torch.isfinite(la.value)) and all(
        bool(torch.isfinite(w.grad.value).all()) for w in pw.values())

    def step_ms(fn, clear, n=10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
            clear()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    api_ms = step_ms(api_step, lambda: [w.clear_grad()
                                        for w in pw.values()])
    direct_ms = step_ms(direct_step, lambda: [setattr(w, "grad", None)
                                              for w in tw.values()])
    api_ms2 = step_ms(api_step, lambda: [w.clear_grad()
                                         for w in pw.values()])
    a1 = pt.to_tensor([1.0], place="gpu")
    b1 = pt.to_tensor([2.0], place="gpu")
    ta1, tb1 = a1.value, b1.value
    us_api = per_op_us(torch, pt.add, a1, b1)
    us_torch = per_op_us(torch, torch.add, ta1, tb1)
    cost = api_cost_us(torch, pt.add, a1, b1, ta1, tb1)
    if parent is not None:
        # change, parent, parent, change, three times over; both statistics
        pp = import_parent_package(parent)
        pa1 = pp.to_tensor([1.0], place="gpu")
        pb1 = pp.to_tensor([2.0], place="gpu")
        reads = {"change": [], "parent": []}
        for tag in ("change", "parent", "parent", "change") * 3:
            add, a, b = ((pt.add, a1, b1) if tag == "change"
                         else (pp.add, pa1, pb1))
            reads[tag].append((
                api_cost_us(torch, add, a, b, ta1, tb1),
                per_op_us(torch, add, a, b)
                - per_op_us(torch, torch.add, ta1, tb1)))
        for tag, r in reads.items():
            log(f"tensor_api api cost {tag} [{card}]: api_cost_us "
                + " ".join(f"{c:.3f}" for c, _ in r)
                + "; pt.add less torch.add, 10,000 calls in a row "
                + " ".join(f"{d:.3f}" for _, d in r))
    log(f"tensor_api block [{card}]: llama_350m widths ({H} hidden, {heads} "
        f"heads of {H // heads}, {bw['inter']} intermediate), bf16, "
        f"{B} x {S} tokens, loss {la.item():.6f}; bitwise API = direct: "
        f"{same}; launches {counts}")
    log(f"tensor_api metrics [{card}]: API block {api_ms:.3f} / "
        f"{api_ms2:.3f} ms a step (forward + backward), direct block "
        f"{direct_ms:.3f} ms; pt.add {us_api:.2f} us a call, torch.add "
        f"{us_torch:.2f} us (10,000 calls in a row: a difference of "
        f"{us_api - us_torch:.2f} us), the API's cost {cost:.3f} us a "
        f"dispatched op (api_cost_us)")
    want = {"k5_fwd": 2, "k4_fwd": 1, "k4_dq": 1, "k4_dkv": 1, "k5_bwd": 2}
    checks = {"every optable row on the card = numpy = CPU": not fails,
              "loss and every gradient bitwise the direct block's":
                  all(same.values()),
              "finite loss and gradients": finite,
              "launches K5a 2, K4a 1, K4b 1 (dq, dk + dv), K5b 2":
                  {k: counts[k] for k in want} == want,
              "no other kernel": not any(
                  v for k, v in counts.items() if k not in want),
              f"the API's cost a dispatched op within the parent's spread "
              f"of the same statistic (<= {API_US_SPREAD[1]} us)":
                  cost <= API_US_SPREAD[1]}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"tensor_api: check failed: {name}")
    record["flash_attention_fwd"]["tensor_api_launches"] = counts["k4_fwd"]
    record["flash_attention_bwd"]["tensor_api_launches"] = counts["k4_dq"]
    record["rms_norm_fwd"]["tensor_api_launches"] = counts["k5_fwd"]
    record["rms_norm_bwd"]["tensor_api_launches"] = counts["k5_bwd"]


# ------------------------------------------------------------ nn_layers

# (c)'s Transformer-base: nn.Transformer()'s own defaults (Vaswani et al.
# 2017: d_model 512, 8 heads of 64, 6 + 6 layers, FFN 2048, ReLU,
# post-norm) with a shared 37,000-token embedding and output projection
# (the paper's EN-DE BPE vocabulary); (batch, source, target) tokens
TBASE = {"d_model": 512, "nhead": 8, "layers": 6, "ffn": 2048,
         "vocab": 37000, "parity": (2, 128, 120), "train": (64, 128, 120),
         "steps": 10}
# (d)'s LSTM: 2 layers, input and hidden 1024, batch 32 x 128 steps; the
# card against the CPU at batch 2
NN_LSTM = {"hidden": 1024, "layers": 2, "B": 32, "T": 128, "check_B": 2}
# (a)'s fills timed at 4096 x 4096 f32, and the randn moments' size
NN_FILL = (4096, 4096)
NN_MOMENTS = 1 << 26
# (e)'s calls a timing of Layer.__call__ against torch.nn.Module.__call__
NN_HOST_CALLS = 2000
# the layer table's tolerances (card against CPU, each tensor's largest
# |error| over its largest |value|, floor 1): plain torch f32; cuDNN
# (convolutions, pools) and cuSOLVER (Orthogonal's QR) sum in their own
# orders
NN_TOL = {"f32": 1e-5, "cudnn": 1e-4, "cusolver": 1e-5, "lstm": 1e-4}
# (c)'s parity step: the card's loss and gradients against the CPU's
# (K4 against its plain version, cuBLAS against the CPU's GEMMs; same
# weights and dropout masks, R2 being its plain version bit for bit);
# each gradient over its own largest |value|, but the key projections'
# biases: a softmax ignores a shift of its row, so their gradient is 0 in
# exact arithmetic and rounding noise on both sides, held over
# NN_GRAD_FLOOR of the largest gradient of all
TBASE_TOL = {"loss": 1e-4, "grad": 2e-3}
NN_GRAD_FLOOR = 1e-3
NN_ZERO_GRAD = "k_proj.bias"


def nn_scaled_err(torch, got, want, floor=1.0):
    """Largest |got - want| of a tensor over max(its largest |want|,
    ``floor``)."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    if g.numel() == 0:
        return 0.0
    return ((g - w).abs().max() / w.abs().max().clamp_min(floor)).item()


def nn_draws(torch, np, pt, dt):
    """Every random op, ``uniform_``, ``exponential_`` and every
    initializer under ``pt.seed(0)`` on the default place, in ``dt``
    where the op takes a floating type: [(name, torch value)]."""
    from paddle_tpu_torch.nn import initializer as I
    out = []
    pt.seed(0)
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    p = np.random.default_rng(0).uniform(0, 1, (4, 10)).astype(np.float32)
    lam = np.array([0, 0.5, 3, 9.9, 10, 25, 100, 1000] * 8, np.float32)
    ops = {
        "rand": lambda: pt.ops.rand([33, 7], dt),
        "randn": lambda: pt.ops.randn([33, 7], dt),
        "uniform": lambda: pt.ops.uniform([1001], dt, -0.3, 2.0),
        "uniform_seed": lambda: pt.ops.uniform([17], dt, seed=4),
        "gaussian": lambda: pt.ops.gaussian([129], 1.0, 2.0, dt),
        "standard_normal": lambda: pt.ops.standard_normal([5, 5], dt),
        "rand_like": lambda: pt.ops.rand_like(pt.to_tensor(x, dtype=dt)),
        "randn_like": lambda: pt.ops.randn_like(pt.to_tensor(x, dtype=dt)),
        "normal": lambda: pt.ops.normal(0.5, 2.0, [77]),
        "normal_tensor": lambda: pt.ops.normal(pt.to_tensor(x), 2.0),
        "randint": lambda: pt.ops.randint(-5, 17, [50]),
        "randint_like": lambda: pt.ops.randint_like(
            pt.to_tensor(np.zeros(9, np.int32)), 100),
        "randperm": lambda: pt.ops.randperm(37),
        "randperm_two_rounds": lambda: pt.ops.randperm(3000),
        "shuffle": lambda: pt.ops.shuffle(pt.to_tensor(x), 1),
        "multinomial": lambda: pt.ops.multinomial(pt.to_tensor(p), 3),
        "multinomial_replace": lambda: pt.ops.multinomial(
            pt.to_tensor(p[0]), 5, True),
        "bernoulli": lambda: pt.ops.bernoulli(pt.to_tensor(p, dtype=dt)),
        "poisson": lambda: pt.ops.poisson(pt.to_tensor(lam)),
        "uniform_": lambda: pt.to_tensor(x, dtype=dt).uniform_(-2.0, 3.0),
        "exponential_": lambda: pt.to_tensor(x).exponential_(2.0),
    }
    for name, fn in ops.items():
        out.append((name, fn().value))
    inits = {"Constant": I.Constant(0.25), "Normal": I.Normal(0.5, 2.0),
             "TruncatedNormal": I.TruncatedNormal(0.1, 0.02),
             "Uniform": I.Uniform(-0.3, 0.7), "XavierNormal": I.XavierNormal(),
             "XavierUniform": I.XavierUniform(),
             "KaimingNormal": I.KaimingNormal(),
             "KaimingUniform": I.KaimingUniform(),
             "Assign": I.Assign(np.arange(60, dtype=np.float32).reshape(
                 3, 4, 5)),
             "Orthogonal": I.Orthogonal(1.5), "Bilinear": I.Bilinear(),
             "Dirac": I.Dirac(groups=3)}
    shapes = {"Bilinear": (3, 4, 5, 5), "Dirac": (6, 4, 3, 3)}
    for name, init in inits.items():
        out.append((name, init(shapes.get(name, (3, 4, 5)), dt)))
    return out


def nn_layer_table(torch, np, pt):
    """(b)'s rows: (name, builder over ``nn``, inputs, tolerance key,
    card route). Small widths; MultiHeadAttention at head dim 64."""
    rng = np.random.default_rng(5)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    def u(*s):
        return rng.uniform(0.05, 0.95, s).astype(np.float32)

    lbl = np.array([1, 0, 3, 2, 1], np.int32)
    pm = np.array([1, -1, 1, 1, -1], np.float32)
    T = []

    def row(name, make, inputs, tol="f32", route="plain torch", train=False):
        T.append((name, make, inputs, tol, route, train))

    cd = "cuDNN through torch"
    row("Linear", lambda nn: nn.Linear(16, 8), [r(4, 16)])
    row("Embedding", lambda nn: nn.Embedding(50, 8, padding_idx=3),
        [np.array([[1, 3, 7], [3, 49, 0]], np.int32)])
    row("Identity", lambda nn: nn.Identity(), [r(3, 4)])
    row("Dropout", lambda nn: nn.Dropout(0.3), [r(8, 16)], route="R2",
        train=True)
    row("Dropout2D", lambda nn: nn.Dropout2D(0.5), [r(2, 4, 8, 8)],
        route="R2", train=True)
    row("Dropout3D", lambda nn: nn.Dropout3D(0.5), [r(2, 4, 2, 4, 4)],
        route="R2", train=True)
    row("AlphaDropout", lambda nn: nn.AlphaDropout(0.2), [r(8, 16)],
        route="R2", train=True)
    row("Flatten", lambda nn: nn.Flatten(), [r(2, 3, 4)])
    row("Unflatten", lambda nn: nn.Unflatten(1, [2, 3]), [r(2, 6, 4)])
    row("Pad1D", lambda nn: nn.Pad1D([1, 2]), [r(2, 3, 4)])
    row("Pad2D", lambda nn: nn.Pad2D([1, 0, 2, 1], mode="reflect"),
        [r(1, 2, 4, 5)])
    row("Pad3D", lambda nn: nn.Pad3D([1, 1, 0, 1, 1, 0]), [r(1, 1, 2, 3, 3)])
    row("Upsample", lambda nn: nn.Upsample(size=[7, 5], mode="bicubic"),
        [r(1, 2, 12, 9)])
    row("UpsamplingBilinear2D", lambda nn: nn.UpsamplingBilinear2D(
        scale_factor=2), [r(1, 2, 4, 4)])
    row("UpsamplingNearest2D", lambda nn: nn.UpsamplingNearest2D(
        scale_factor=2), [r(1, 2, 4, 4)])
    row("CosineSimilarity", lambda nn: nn.CosineSimilarity(), [r(3, 5),
                                                              r(3, 5)])
    row("Bilinear", lambda nn: nn.Bilinear(3, 4, 5), [r(2, 3), r(2, 4)])
    for dims, shape in ((1, (2, 4, 16)), (2, (2, 4, 12, 12)),
                        (3, (1, 4, 6, 6, 6))):
        row(f"Conv{dims}D", (lambda d: lambda nn: getattr(nn, f"Conv{d}D")(
            4, 8, 3, padding=1, groups=2))(dims), [r(*shape)], "cudnn", cd)
        row(f"Conv{dims}DTranspose", (lambda d: lambda nn: getattr(
            nn, f"Conv{d}DTranspose")(4, 6, 3, stride=2, padding=1,
                                      output_padding=1, groups=2))(dims),
            [r(*shape)], "cudnn", cd)
    row("Conv2D_NHWC_SAME", lambda nn: nn.Conv2D(
        4, 4, 3, stride=2, padding="SAME", data_format="NHWC"),
        [r(2, 9, 8, 4)], "cudnn", cd)
    row("LayerNorm", lambda nn: nn.LayerNorm(32), [r(4, 32)])
    row("RMSNorm", lambda nn: nn.RMSNorm(256), [r(8, 256)], route="K5a, K5b")
    for name, shape in (("BatchNorm", (4, 3, 4, 4)), ("BatchNorm1D", (4, 3, 8)),
                        ("BatchNorm2D", (4, 3, 4, 4)),
                        ("BatchNorm3D", (2, 3, 2, 4, 4)),
                        ("SyncBatchNorm", (4, 3, 4, 4))):
        row(name, (lambda n: lambda nn: getattr(nn, n)(3))(name),
            [r(*shape)], train=True)
    row("GroupNorm", lambda nn: nn.GroupNorm(2, 4), [r(2, 4, 5, 5)])
    for dims, shape in (("1D", (2, 3, 8)), ("2D", (2, 3, 5, 5)),
                        ("3D", (2, 3, 2, 4, 4))):
        row("InstanceNorm" + dims, (lambda d: lambda nn: getattr(
            nn, "InstanceNorm" + d)(3))(dims), [r(*shape)])
    row("LocalResponseNorm", lambda nn: nn.LocalResponseNorm(3),
        [r(2, 5, 4, 4)])
    row("SpectralNorm", lambda nn: nn.SpectralNorm([8, 6], power_iters=2),
        [r(8, 6)])
    for act, kw in (("ReLU", {}), ("ReLU6", {}), ("GELU", {}), ("SiLU", {}),
                    ("Swish", {}), ("LeakyReLU", {"negative_slope": 0.2}),
                    ("ELU", {}), ("CELU", {}), ("SELU", {}), ("RReLU", {}),
                    ("Sigmoid", None), ("LogSigmoid", None), ("Tanh", None),
                    ("Tanhshrink", {}), ("Hardshrink", {}),
                    ("Softshrink", {}), ("Hardsigmoid", {}),
                    ("Hardswish", {}), ("Hardtanh", {}), ("Mish", {}),
                    ("Softmax", {}), ("LogSoftmax", {}), ("Softplus", {}),
                    ("Softsign", {}), ("ThresholdedReLU", {}),
                    ("GLU", {"axis": 1})):
        row(act, (lambda a, k: lambda nn: getattr(nn, a)(**(k or {})))(
            act, kw), [r(4, 6, 8)])
    row("PReLU", lambda nn: nn.PReLU(4), [r(2, 4, 5)])
    row("Maxout", lambda nn: nn.Maxout(2), [r(2, 6, 5)])
    for name, args, kw, shape in (
            ("MaxPool1D", (3,), {"stride": 2, "padding": 1}, (2, 4, 17)),
            ("MaxPool2D", (3,), {"stride": 2, "padding": 1}, (2, 4, 9, 9)),
            ("MaxPool3D", (2,), {}, (1, 2, 4, 4, 4)),
            ("AvgPool1D", (3,), {"stride": 2, "padding": 1}, (2, 4, 17)),
            ("AvgPool2D", (3,), {"stride": 2, "padding": 1,
                                 "exclusive": False}, (2, 4, 9, 9)),
            ("AvgPool3D", (2,), {"padding": 1}, (1, 2, 3, 4, 4)),
            ("AdaptiveAvgPool1D", (5,), {}, (2, 3, 17)),
            ("AdaptiveAvgPool2D", ((3, 4),), {}, (2, 3, 10, 9)),
            ("AdaptiveAvgPool3D", (2,), {}, (1, 2, 5, 4, 6)),
            ("AdaptiveMaxPool1D", (5,), {}, (2, 3, 17)),
            ("AdaptiveMaxPool2D", ((3, 4),), {}, (2, 3, 10, 9))):
        pool_route = cd if "Adaptive" not in name else "plain torch"
        row(name, (lambda n, a, k: lambda nn: getattr(nn, n)(*a, **k))(
            name, args, kw), [r(*shape)],
            "cudnn" if "Adaptive" not in name else "f32", pool_route)
    row("PixelShuffle", lambda nn: nn.PixelShuffle(2), [r(1, 8, 3, 3)])
    for name, make, inputs in (
            ("CrossEntropyLoss", lambda nn: nn.CrossEntropyLoss(),
             [r(5, 4), lbl]),
            ("MSELoss", lambda nn: nn.MSELoss(), [r(3, 4), r(3, 4)]),
            ("L1Loss", lambda nn: nn.L1Loss(), [r(3, 4), r(3, 4)]),
            ("NLLLoss", lambda nn: nn.NLLLoss(), [r(5, 4), lbl]),
            ("BCELoss", lambda nn: nn.BCELoss(), [u(3, 4), u(3, 4)]),
            ("BCEWithLogitsLoss", lambda nn: nn.BCEWithLogitsLoss(),
             [r(3, 4), u(3, 4)]),
            ("KLDivLoss", lambda nn: nn.KLDivLoss(), [r(3, 4), u(3, 4)]),
            ("SmoothL1Loss", lambda nn: nn.SmoothL1Loss(), [r(3, 4),
                                                           r(3, 4)]),
            ("MarginRankingLoss", lambda nn: nn.MarginRankingLoss(0.1),
             [r(5), r(5), pm]),
            ("CosineEmbeddingLoss", lambda nn: nn.CosineEmbeddingLoss(),
             [r(5, 3), r(5, 3), pm]),
            ("TripletMarginLoss", lambda nn: nn.TripletMarginLoss(),
             [r(4, 3), r(4, 3), r(4, 3)]),
            ("HingeEmbeddingLoss", lambda nn: nn.HingeEmbeddingLoss(),
             [r(5), pm])):
        row(name, make, inputs)
    row("SimpleRNN", lambda nn: nn.SimpleRNN(8, 16, direction="bidirect"),
        [r(2, 6, 8)])
    row("LSTM", lambda nn: nn.LSTM(8, 16, num_layers=2), [r(2, 6, 8)])
    row("GRU", lambda nn: nn.GRU(8, 16, time_major=True), [r(6, 2, 8)])
    row("SimpleRNNCell", lambda nn: nn.SimpleRNNCell(8, 16), [r(2, 8)])
    row("LSTMCell", lambda nn: nn.LSTMCell(8, 16), [r(2, 8)])
    row("GRUCell", lambda nn: nn.GRUCell(8, 16), [r(2, 8)])
    row("RNN", lambda nn: nn.RNN(nn.GRUCell(8, 16)), [r(2, 6, 8)])
    row("BiRNN", lambda nn: nn.BiRNN(nn.LSTMCell(8, 16),
                                     nn.LSTMCell(8, 16)), [r(2, 6, 8)])
    row("MultiHeadAttention", lambda nn: nn.MultiHeadAttention(256, 4),
        [r(2, 32, 256)], route="K4a, K4b")
    row("MultiHeadAttention_hd32", lambda nn: nn.MultiHeadAttention(256, 8),
        [r(2, 32, 256)], route="K4a, K4b")
    row("MultiHeadAttention_hd96", lambda nn: nn.MultiHeadAttention(768, 8),
        [r(2, 32, 768)], route="K4a, K4b")
    row("MultiHeadAttention_mask", lambda nn: nn.MultiHeadAttention(64, 2),
        [r(2, 8, 64), r(2, 8, 64), r(2, 8, 64),
         np.tril(np.ones((1, 1, 8, 8), bool))],
        route="the composition (a mask)")
    row("TransformerEncoderLayer", lambda nn: nn.TransformerEncoderLayer(
        64, 4, 128, attn_dropout=0.0), [r(2, 8, 64)],
        route="K4a, K4b; R2", train=True)
    row("TransformerEncoder", lambda nn: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0), 2),
        [r(2, 8, 64)], route="K4a, K4b")
    row("TransformerDecoderLayer", lambda nn: nn.TransformerDecoderLayer(
        64, 4, 128, dropout=0.0), [r(2, 6, 64), r(2, 8, 64)],
        route="K4a, K4b")
    row("TransformerDecoder", lambda nn: nn.TransformerDecoder(
        nn.TransformerDecoderLayer(64, 4, 128, dropout=0.0), 2),
        [r(2, 6, 64), r(2, 8, 64)], route="K4a, K4b")
    row("Transformer", lambda nn: nn.Transformer(
        64, 4, 1, 1, 128, dropout=0.0), [r(2, 8, 64), r(2, 6, 64)],
        route="K4a, K4b")
    return T


def nn_first(out):
    """A layer's output tensor (the first of a tuple, recursively)."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def nn_layer_run(torch, np, pt, device, make, inputs, train):
    """Build ``make(pt.nn)`` under ``pt.seed(0)`` on ``device``, run it on
    ``inputs`` and backward of ``sum(out * w)`` (w from seed 0): (output,
    input gradients, {parameter: gradient}, the layer)."""
    pt.set_device("gpu" if device == "cuda" else "cpu")
    pt.seed(0)
    layer = make(pt.nn)
    layer.train() if train else layer.eval()
    xs = [torch.tensor(x, device=device) for x in inputs]
    for x in xs:
        if x.is_floating_point():
            x.requires_grad_()
    pt.seed(1)
    out = nn_first(layer(*xs))
    w = torch.tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, tuple(out.shape)).astype(np.float32), device=device)
    (out * w).sum().backward()
    grads = {n: p.grad for n, p in layer.named_parameters()
             if p.grad is not None}
    return out, [x.grad for x in xs if x.requires_grad], grads, layer


def nn_table(torch, np, pt):
    """(b): every row on the card and on the CPU under the same seeds:
    (rows, fails, {row: K launches}, the largest error by tolerance)."""
    from paddle_tpu_torch import nn
    fails, launches, worst = [], {}, {}
    table = nn_layer_table(torch, np, pt)
    for name, make, inputs, tol, route, train in table:
        zero_counts()
        try:
            co, cdx, cg, _ = nn_layer_run(torch, np, pt, "cuda", make,
                                          inputs, train)
            torch.cuda.synchronize()
            counts = read_counts()
            ho, hdx, hg, _ = nn_layer_run(torch, np, pt, "cpu", make,
                                          inputs, train)
        except Exception as e:           # noqa: BLE001 — reported below
            fails.append(f"{name}: {type(e).__name__}: {e}")
            continue
        launches[name] = {k: v for k, v in counts.items() if v}
        errs = [nn_scaled_err(torch, co, ho)]
        if [a is None for a in cdx] != [b is None for b in hdx]:
            fails.append(f"{name}: input gradients differ in presence")
        errs += [nn_scaled_err(torch, a, b) for a, b in zip(cdx, hdx)
                 if a is not None and b is not None]
        if set(cg) != set(hg):
            fails.append(f"{name}: gradients of {sorted(cg)} vs "
                         f"{sorted(hg)}")
        errs += [nn_scaled_err(torch, cg[k], hg[k]) for k in cg if k in hg]
        err = max(errs)
        worst[tol] = max(worst.get(tol, 0.0), err)
        if not err <= NN_TOL[tol]:
            fails.append(f"{name} ({route}): card against CPU {err:.3g} > "
                         f"{NN_TOL[tol]}")
    names = {n.split("_")[0] for n, *_ in table}
    listed = set(nn.layers_basic.__all__) | set(nn.rnn.__all__) | set(
        nn.transformer.__all__)
    missing = listed - names - {"RNNCellBase"}
    if missing:
        fails.append(f"no row for {sorted(missing)}")
    return table, fails, launches, worst


def nn_transformer_base(pt, np, attn_dropout=0.0):
    """(c)'s model on the default place: ``nn.Transformer`` at TBASE's
    widths (dropout 0.1), a shared N(0, 1/d_model) embedding scaled by
    sqrt(d_model) plus sinusoidal positions, and the embedding as the
    output projection."""
    nn, F = pt.nn, pt.nn.functional
    d = TBASE["d_model"]

    class TransformerBase(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(
                TBASE["vocab"], d,
                weight_attr=nn.initializer.Normal(0.0, d ** -0.5))
            self.core = nn.Transformer(
                d, TBASE["nhead"], TBASE["layers"], TBASE["layers"],
                TBASE["ffn"], dropout=0.1, attn_dropout=attn_dropout)
            pos = np.arange(512)[:, None] / np.power(
                10000.0, np.arange(0, d, 2)[None, :] / d)
            pe = np.zeros((512, d), np.float32)
            pe[:, 0::2], pe[:, 1::2] = np.sin(pos), np.cos(pos)
            self.register_buffer("pe", pt.to_tensor(pe), persistable=False)

        def embed_at(self, ids):
            return self.embed(ids) * (d ** 0.5) + self.pe[:ids.shape[1]]

        def forward(self, src, tgt):
            mask = self.core.generate_square_subsequent_mask(
                tgt.shape[1]).value
            out = self.core(self.embed_at(src), self.embed_at(tgt),
                            tgt_mask=mask)
            return F.linear(out, self.embed.weight.T)

    return TransformerBase()


def nn_dropout_layers(model):
    """The model's ``Dropout`` layers with a rate, each called once a
    forward."""
    from paddle_tpu_torch.nn import Dropout
    return sum(1 for m in model.sublayers() if isinstance(m, Dropout)
               and m.p > 0)


def nn_tbase_batch(torch, np, shape, device, seed=0):
    B, Ss, St = shape
    rng = np.random.default_rng(seed)
    src = torch.tensor(rng.integers(0, TBASE["vocab"], (B, Ss)),
                       device=device)
    tgt = torch.tensor(rng.integers(0, TBASE["vocab"], (B, St + 1)),
                       device=device)
    return src, tgt[:, :-1], tgt[:, 1:]


def nn_tbase_step(pt, model, src, tin, tout):
    from paddle_tpu_torch.nn import functional as F
    logits = model(src, tin)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tout.reshape(-1))


def nn_host_us(torch, fn):
    """Microseconds a call of ``fn`` over NN_HOST_CALLS calls, the card
    drained before and after."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(NN_HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / NN_HOST_CALLS * 1e6


def nn_tbase_launches_ok(counts, steps, layers, drops):
    """Transformer-base's launches over ``steps`` steps: K4a and K4b's two
    kernels each 2 x ``layers`` a step (the encoder's self-attention, the
    decoder's cross-attention), R2's dropout 2 x ``drops`` (forward and
    vjp), no fill."""
    per = 2 * layers * steps
    return counts["k4_fwd"] == per and counts["k4_dq"] == per and \
        counts["k4_dkv"] == per and \
        counts["r2_dropout"] == 2 * drops * steps and counts["r2_fill"] == 0


def phase_nn_layers(torch, np, card, peak, record):
    """Phase nn_layers: (a) the random draws, (b) the layer table, (c)
    Transformer-base, (d) an LSTM, (e) the host's cost of a Layer call."""
    import copy
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.ops.kernels import threefry_fill as tf
    from paddle_tpu_torch.optimizer import AdamW
    checks = {}
    t_phase = time.perf_counter()
    try:
        # (a) the draws: card against CPU, bit for bit
        modes0 = dict(tf.fill.mode_launches)
        bad, n_draws = [], 0
        for dt in ("float32", "bfloat16"):
            pt.set_device("gpu")
            on_card = nn_draws(torch, np, pt, dt)
            torch.cuda.synchronize()
            pt.set_device("cpu")
            on_cpu = nn_draws(torch, np, pt, dt)
            for (name, a), (_, b) in zip(on_card, on_cpu):
                n_draws += 1
                if a.device.type != "cuda":
                    bad.append(f"{name} {dt}: made on {a.device}")
                elif name == "Orthogonal":      # cuSOLVER's QR
                    if not nn_scaled_err(torch, a, b) <= NN_TOL["cusolver"]:
                        bad.append(f"{name} {dt}: QR beyond its tolerance")
                elif not same_bits(torch, a.cpu(), b):
                    bad.append(f"{name} {dt}: card and CPU differ")
        modes = {k: v - modes0[k] for k, v in tf.fill.mode_launches.items()}
        log(f"nn_layers draws: {n_draws} draws (the random ops, uniform_, "
            f"exponential_, the initializers; f32 and bf16) on the card "
            f"against the CPU; R2 launches by mode {modes}; differ: {bad}")
        checks["every draw bit for bit the CPU's (Orthogonal's QR within "
               f"{NN_TOL['cusolver']})"] = not bad
        checks["R2 drew bits, uniform, normal and truncated normal on the "
               "card"] = all(modes[k] for k in ("bits", "uniform", "normal",
                                                "truncated_normal"))
        pt.set_device("gpu")
        pt.seed(0)
        big = pt.ops.randn([NN_MOMENTS]).value
        mean, std = big.double().mean().item(), big.double().std().item()
        del big
        log(f"nn_layers randn moments: {NN_MOMENTS} draws, mean {mean:.6f}, "
            f"std {std:.6f}")
        checks["randn of 2**26: mean within 1e-3 of 0, std of 1"] = \
            abs(mean) < 1e-3 and abs(std - 1.0) < 1e-3
        if not RATES:
            card_rates(torch)
        key = prng.PRNGKey(3)
        n_el = NN_FILL[0] * NN_FILL[1]
        fills = {}
        for mode, fn, yard, need_el in (
                ("uniform", lambda: tf.uniform(key, NN_FILL, "cuda"),
                 lambda: torch.rand(NN_FILL, device="cuda"),
                 plus(HASH, UNIFORM)),
                ("normal", lambda: tf.normal(key, NN_FILL, "cuda"),
                 lambda: torch.randn(NN_FILL, device="cuda"),
                 plus(HASH, UNIFORM, {"fp32": 12}))):
            ms = cuda_ms(fn, torch)
            yard_ms = cuda_ms(yard, torch)
            b_ms, by, term = bound(4 * n_el, 0, peak,
                                   instr=ops_of((n_el, need_el)), term=True)
            bytes_ms = 4 * n_el / peak[0] * 1e3
            fills[mode] = {"ms": ms, "bound_ms": b_ms, "bound_by": by,
                           "bytes_ms": bytes_ms, "torch_ms": yard_ms}
            log(f"nn_layers fill {mode} [{card}]: {NN_FILL[0]} x "
                f"{NN_FILL[1]} f32 {ms:.4f} ms; bound {b_ms:.4f} ms ({by}: "
                f"{term}; the bytes alone {bytes_ms:.4f} ms); torch."
                f"{'rand' if mode == 'uniform' else 'randn'} (Philox, "
                f"another function) {yard_ms:.4f} ms")
        record["threefry_fill"]["fills"] = fills
        # (b) the layer table
        t_table = time.perf_counter()
        table, fails, launches, worst = nn_table(torch, np, pt)
        log(f"nn_layers table: {len(table)} rows, card against CPU, "
            f"forward and backward; largest error by tolerance "
            f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }; "
            f"{time.perf_counter() - t_table:.1f} s")
        for name, _, _, tol, route, _ in table:
            if route != "plain torch":
                log(f"  nn_layers row {name}: {route}, tolerance "
                    f"{NN_TOL[tol]}, launches {launches.get(name)}")
        for f in fails:
            log(f"  nn_layers table FAIL {f}")
        checks["every row within its tolerance"] = not fails
        want_rms = {"k5_fwd": 1, "k5_bwd": 1}
        checks["RMSNorm launches K5a 1, K5b 1"] = {
            k: launches.get("RMSNorm", {}).get(k, 0) for k in want_rms} \
            == want_rms
        checks["MultiHeadAttention (head dims 64, 32, 96; no mask, eval) "
               "launches K4a 1"] = all(
                   launches.get(n, {}).get("k4_fwd") == 1 for n in (
                       "MultiHeadAttention", "MultiHeadAttention_hd32",
                       "MultiHeadAttention_hd96"))
        # (c) Transformer-base
        pt.set_device("gpu")
        pt.seed(0)
        card_m = nn_transformer_base(pt, np)
        # the same model on the CPU: its weights are the card's (whose
        # draws (a) held to the CPU's bit for bit; drawing 60 M normals
        # with the plain version takes a minute)
        cpu_m = copy.deepcopy(card_m).to("cpu")
        n_params = sum(p.numel() for p in card_m.parameters())
        drops = nn_dropout_layers(card_m)
        src, tin, tout = nn_tbase_batch(torch, np, TBASE["parity"], "cuda")
        pt.set_device("gpu")
        zero_counts()
        pt.seed(7)
        loss_c = nn_tbase_step(pt, card_m, src, tin, tout)
        loss_c.backward()
        torch.cuda.synchronize()
        counts = read_counts()
        pt.set_device("cpu")
        pt.seed(7)
        loss_h = nn_tbase_step(pt, cpu_m, src.cpu(), tin.cpu(), tout.cpu())
        loss_h.backward()
        loss_err = abs(loss_c.item() - loss_h.item()) / abs(loss_h.item())
        hp = dict(cpu_m.named_parameters())
        gmax = max(g.grad.abs().max().item() for g in hp.values())
        grad_errs = {n: nn_scaled_err(torch, p.grad, hp[n].grad,
                                      NN_GRAD_FLOOR * gmax
                                      if n.endswith(NN_ZERO_GRAD) else 0.0)
                     for n, p in card_m.named_parameters()}
        worst_grad = max(grad_errs, key=grad_errs.get)
        grad_err = grad_errs[worst_grad]
        proj = {w: max(e for n, e in grad_errs.items()
                       if f"{w}_proj." in n and not n.endswith(NN_ZERO_GRAD))
                for w in ("q", "k", "v")}
        zero = max(e for n, e in grad_errs.items()
                   if n.endswith(NN_ZERO_GRAD))
        L = TBASE["layers"]
        log(f"nn_layers Transformer-base parity [{card}]: {n_params} "
            f"parameters, {TBASE['parity']} (batch, source, target) tokens, "
            f"f32: loss {loss_c.item():.6f} card, {loss_h.item():.6f} CPU "
            f"(relative {loss_err:.3g}); largest gradient error {grad_err:.3g}"
            f" ({worst_grad}); q / k / v projections' largest "
            f"{ {w: float(f'{e:.3g}') for w, e in proj.items()} }, the key "
            f"biases' (over {NN_GRAD_FLOOR} of the largest gradient) "
            f"{zero:.3g}; launches {counts}; {drops} dropout layers")
        checks[f"Transformer-base loss within {TBASE_TOL['loss']} and "
               f"gradients within {TBASE_TOL['grad']} of the CPU's"] = \
            loss_err <= TBASE_TOL["loss"] and grad_err <= TBASE_TOL["grad"]
        checks[f"Transformer-base parity step launches K4a {2 * L}, K4b "
               f"{2 * L} + {2 * L}, R2 dropout 2 x {drops}, no fill"] = \
            nn_tbase_launches_ok(counts, 1, L, drops)
        del cpu_m, hp

        def train_run(model, steps):
            opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
            src, tin, tout = nn_tbase_batch(torch, np, TBASE["train"],
                                            "cuda", seed=1)
            losses, times = [], []
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                with amp.auto_cast(level="O1", dtype="bfloat16"):
                    loss = nn_tbase_step(pt, model, src, tin, tout)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
                times.append(time.perf_counter() - t)
            return losses, times

        pt.set_device("gpu")
        steps = TBASE["steps"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, times = train_run(card_m, steps)
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        B, Ss, St = TBASE["train"]
        ms = float(np.median(times[1:])) * 1e3
        log(f"nn_layers Transformer-base train [{card}]: {B} x {Ss} / {St} "
            f"tokens, AdamW, auto_cast bf16, attn_dropout 0: losses "
            f"{[round(v, 4) for v in losses]}; {ms:.1f} ms a step "
            f"(median of {len(times) - 1}), {B * (Ss + St) / ms * 1e3:.0f} "
            f"tokens/s, peak {peak_gb:.2f} GiB; launches over {steps} steps "
            f"{counts}")
        checks["Transformer-base loss finite and falling"] = all(
            math.isfinite(v) for v in losses) and losses[-1] < losses[0]
        checks[f"Transformer-base train launches {steps} x (K4a {2 * L}, "
               f"K4b {2 * L} + {2 * L}, R2 dropout 2 x {drops}), no fill"] = \
            nn_tbase_launches_ok(counts, steps, L, drops)
        record["flash_attention_fwd"]["nn_layers_launches"] = \
            counts["k4_fwd"]
        record["flash_attention_bwd"]["nn_layers_launches"] = counts["k4_dq"]
        record["threefry_fill"]["nn_layers_launches"] = counts["r2_dropout"]
        profile_once(torch, lambda: train_run(card_m, 1), card,
                     "nn_layers Transformer-base")
        del card_m
        torch.cuda.empty_cache()
        pt.seed(0)
        comp_m = nn_transformer_base(pt, np, attn_dropout=0.1)
        _, ctimes = train_run(comp_m, 4)
        cms = float(np.median(ctimes[1:])) * 1e3
        log(f"nn_layers Transformer-base train [{card}]: paddle's default "
            f"attn_dropout 0.1 (attention by the composition) {cms:.1f} ms "
            f"a step (median of {len(ctimes) - 1})")
        del comp_m
        torch.cuda.empty_cache()
        # (d) the LSTM
        H, Ln = NN_LSTM["hidden"], NN_LSTM["layers"]
        T, Bl, Bc = NN_LSTM["T"], NN_LSTM["B"], NN_LSTM["check_B"]
        x = np.random.default_rng(2).standard_normal((Bl, T, H)).astype(
            np.float32)
        outs = {}
        for dev in ("cuda", "cpu"):
            pt.set_device("gpu" if dev == "cuda" else "cpu")
            pt.seed(0)
            lstm = pt.nn.LSTM(H, H, num_layers=Ln)
            xs = torch.tensor(x[:Bc], device=dev, requires_grad=True)
            out, (h, c) = lstm(xs)
            (out.sum() + h.sum()).backward()
            outs[dev] = [out, h, c, xs.grad] + [p.grad for p in
                                                lstm.parameters()]
            if dev == "cuda":
                card_lstm = lstm
        lstm_err = max(nn_scaled_err(torch, a, b) for a, b in
                       zip(outs["cuda"], outs["cpu"]))
        xb = torch.tensor(x, device="cuda")

        def lstm_step():
            out, (h, c) = card_lstm(xb)
            out.sum().backward()

        lstm_ms = event_ms(lstm_step, torch, iters=5, warmup=1)
        log(f"nn_layers LSTM [{card}]: {Ln} layers, input and hidden {H}; "
            f"card against CPU at batch {Bc} x {T}: largest error "
            f"{lstm_err:.3g}; {Bl} x {T} forward + backward {lstm_ms:.1f} "
            f"ms")
        checks[f"LSTM within {NN_TOL['lstm']} of the CPU"] = \
            lstm_err <= NN_TOL["lstm"]
        # (e) the host's cost of Layer.__call__ (hooks, the Tensor test)
        # over torch.nn.Module.__call__, on one Linear's forward
        pt.set_device("gpu")
        lin = pt.nn.Linear(64, 64)
        xs = torch.randn(8, 64, device="cuda")
        xt = pt.to_tensor(xs)
        calls = {"Layer.__call__": lambda: lin(xs),
                 "torch.nn.Module.__call__":
                     lambda: torch.nn.Module.__call__(lin, xs),
                 "Layer.__call__ on a Tensor": lambda: lin(xt)}
        us = dict.fromkeys(calls, math.inf)
        with torch.no_grad():
            for _ in range(3):                  # in turns, the least
                for name, fn in calls.items():
                    us[name] = min(us[name], nn_host_us(torch, fn))
        log(f"nn_layers host [{card}]: a Linear(64, 64) forward at 8 rows, "
            f"us a call (least of 3 turns of {NN_HOST_CALLS}) "
            f"{ {k: float(f'{v:.3f}') for k, v in us.items()} }")
    finally:
        tdevice._default[0] = None
    log(f"nn_layers phase {time.perf_counter() - t_phase:.1f} s; checks "
        f"{checks}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"nn_layers: check failed: {name}")


# ------------------------------------------------------------------ the zoo

# zoo_parity: card against CPU in f32, values (logits, losses, op
# outputs) over max(|value|, 1) and gradients by nn_layers' rule: each
# over its own largest |value|, but the key projections' biases
# (NN_ZERO_GRAD), held over NN_GRAD_FLOOR of the model's largest gradient
ZOO_TOL = {"value": 1e-5, "grad": 1e-3, "op_grad": 1e-4}
# zoo: BERT-base pretraining at 32 x 512 (and classification at 32 x
# 128), DiT-S/4 at the DiT paper's batch 256, Qwen-VL on 4 images with
# 32-token prompts and 32 new tokens; each trained model takes 2 warm-up
# steps and ZOO["steps"] timed ones
ZOO = {"bert": (32, 512), "bert_cls": (32, 128), "dit_batch": 256,
       "vl": (4, 32, 32), "steps": 8, "mask_id": 103}


def zoo_tiny_models(torch, np, pt):
    """zoo_parity's models, built on the CPU under ``pt.seed(0)``: the
    repo's tiny configurations, DiT's and the ViT's heads cut from 4 to
    2 (head dim 16: K4 takes 16 to 128), DiT's zero-initialised adaLN and
    final projections drawn N(0, 0.05) so that every block carries
    signal."""
    from paddle_tpu_torch import models as M
    pt.set_device("cpu")
    pt.seed(0)
    bert = M.BertForPretraining(M.bert_tiny())
    dit = M.DiTForDiffusion(M.dit_tiny(num_heads=2))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in dit.named_parameters():
            if ".ada." in n or n.startswith("dit.final_layer.linear"):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    cfg = M.qwen_vl_tiny()
    cfg.vision.num_heads = 2
    vl = M.QwenVL(cfg, device="cpu")
    return bert, dit, vl


def zoo_tiny_inputs(np):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 128, (2, 16))
    labels = np.where(rng.random((2, 16)) < 0.15, ids, -100)
    labels[0, 0] = ids[0, 0]                   # at least one label
    mask = np.ones((2, 16), np.int64)
    mask[1, 12:] = 0
    return {"bert": (ids, labels, rng.integers(0, 2, (2,)), mask),
            "dit": (rng.standard_normal((2, 3, 8, 8)).astype(np.float32),
                    np.array([10, 990]),
                    rng.standard_normal((2, 3, 8, 8)).astype(np.float32),
                    np.array([3, 10])),
            "vl": (rng.integers(0, 256, (2, 12)),
                   rng.standard_normal((2, 3, 16, 16)).astype(np.float32))}


def zoo_tiny_run(torch, np, name, model, data, device):
    """One forward, loss and backward of a tiny model on ``device``:
    ({value name: tensor}, {parameter: gradient})."""
    def t(a):
        return torch.as_tensor(a, device=device)
    model.train()
    for p in model.parameters():
        p.grad = None
    out = {}
    if name == "bert":
        ids, labels, nsp, mask = (t(a) for a in data)
        mlm, ns = model(ids)
        loss = model.loss(mlm, ns, labels, nsp)
        out.update(mlm=mlm, nsp=ns, loss=loss)
        with torch.no_grad():
            out["masked_seq"] = model.bert(ids, attention_mask=mask)[0]
    elif name == "dit":
        x0, tt, noise, y = (t(a) for a in data)
        loss = model.loss(x0, tt, noise, y)
        out.update(loss=loss)
        with torch.no_grad():
            out["eps"] = model(x0, tt, y)
    else:
        ids, px = t(data[0]), t(data[1])
        logits = model(ids, px)
        loss = model.loss(logits, ids)
        out.update(logits=logits, loss=loss)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return out, grads


def zoo_tail_rows(torch, np):
    """zoo_parity's rows of the tail: (name, call over (F, nn, tensors),
    numpy inputs, the indices of the inputs to differentiate)."""
    rng = np.random.default_rng(7)

    def r(*s, lo=None, hi=None):
        if lo is not None:
            return rng.uniform(lo, hi, s).astype(np.float32)
        return rng.standard_normal(s).astype(np.float32)

    def ints(hi, *s):
        return rng.integers(0, hi, s).astype(np.int32)

    x4 = r(2, 3, 4, 4)
    win = x4.reshape(2, 3, 2, 2, 2, 2).transpose(0, 1, 2, 4, 3, 5).reshape(
        2, 3, 2, 2, 4)
    arg = win.argmax(-1)
    ix2 = ((np.arange(2)[:, None] * 2 + arg // 2) * 4
           + np.arange(2)[None, :] * 2 + arg % 2).astype(np.int32)
    v2 = win.max(-1)
    x1 = r(2, 3, 6).reshape(2, 3, 3, 2)
    ix1 = (np.arange(3) * 2 + x1.argmax(-1)).astype(np.int32)
    v1 = x1.max(-1)
    ctc = [r(12, 3, 5), np.array([[1, 2, 2, 3], [4, 1, 4, 0], [2, 0, 0, 0]],
                                 np.int32),
           np.array([12, 10, 7], np.int32), np.array([4, 3, 0], np.int32)]
    rnnt = [r(2, 5, 4, 6), np.array([[1, 2, 5], [3, 3, 0]], np.int32),
            np.array([5, 4], np.int32), np.array([3, 2], np.int32)]
    cols = np.array([[[0, 1, 1, 2, 0, 2, 3, 3], [0, 0, 1, 2, 3, 1, 2, 3]]],
                    np.int32)
    off = np.array([[[0, 2, 4, 6, 8], [0, 1, 3, 5, 8]]], np.int32)
    grid = r(2, 4, 3, 2, lo=-1.2, hi=1.2)
    rows = [
        ("affine_grid", lambda F, nn, a: F.affine_grid(a, [2, 3, 4, 5]),
         [r(2, 2, 3)], (0,)),
        ("temporal_shift", lambda F, nn, a: F.temporal_shift(a, 2),
         [r(4, 8, 3, 3)], (0,)),
        ("zeropad2d", lambda F, nn, a: F.zeropad2d(a, [1, 2, 0, 1]),
         [r(1, 2, 3, 3)], (0,)),
        ("pixel_unshuffle", lambda F, nn, a: F.pixel_unshuffle(a, 2),
         [r(1, 2, 4, 6)], (0,)),
        ("channel_shuffle", lambda F, nn, a: F.channel_shuffle(a, 3),
         [r(1, 6, 2, 2)], (0,)),
        ("pairwise_distance", lambda F, nn, a, b: F.pairwise_distance(a, b),
         [r(4, 5), r(4, 5)], (0, 1)),
        ("unfold", lambda F, nn, a: F.unfold(a, 3, 2, 1), [r(2, 3, 6, 7)],
         (0,)),
        ("fold", lambda F, nn, a: F.fold(a, [5, 6], 2), [r(2, 12, 20)],
         (0,)),
        ("max_unpool1d", lambda F, nn, a, i: F.max_unpool1d(a, i, 2),
         [v1, ix1], (0,)),
        ("max_unpool2d", lambda F, nn, a, i: F.max_unpool2d(a, i, 2),
         [v2, ix2], (0,)),
        ("max_unpool3d", lambda F, nn, a, i: F.max_unpool3d(a, i, 2),
         [r(1, 1, 1, 1, 1), np.array([[[[[5]]]]], np.int32)], (0,)),
        ("adaptive_max_pool3d",
         lambda F, nn, a: F.adaptive_max_pool3d(a, [3, 4, 3]),
         [r(1, 2, 5, 7, 4)], (0,)),
        ("square_error_cost", lambda F, nn, a, b: F.square_error_cost(a, b),
         [r(3, 4), r(3, 4)], (0, 1)),
        ("sigmoid_focal_loss",
         lambda F, nn, a, b: F.sigmoid_focal_loss(a, b),
         [r(4, 3), ints(2, 4, 3).astype(np.float32)], (0,)),
        ("huber_loss", lambda F, nn, a, b: F.huber_loss(a, b, delta=0.7),
         [r(3, 4), r(3, 4)], (0, 1)),
        ("soft_margin_loss", lambda F, nn, a, b: F.soft_margin_loss(a, b),
         [r(3, 4), np.sign(r(3, 4))], (0,)),
        ("multi_label_soft_margin_loss",
         lambda F, nn, a, b: F.multi_label_soft_margin_loss(a, b),
         [r(3, 4), ints(2, 3, 4).astype(np.float32)], (0,)),
        ("poisson_nll_loss",
         lambda F, nn, a, b: F.poisson_nll_loss(a, b, full=True),
         [r(3, 4), ints(5, 3, 4).astype(np.float32)], (0,)),
        ("gaussian_nll_loss",
         lambda F, nn, a, b, c: F.gaussian_nll_loss(a, b, c, full=True),
         [r(3, 4), r(3, 4), r(3, 4, lo=0.2, hi=2.0)], (0, 1, 2)),
        ("log_loss", lambda F, nn, a, b: F.log_loss(a, b),
         [r(4, 1, lo=0.05, hi=0.95), ints(2, 4, 1).astype(np.float32)],
         (0,)),
        ("dice_loss", lambda F, nn, a, b: F.dice_loss(a, b),
         [r(3, 4, 5, lo=0.0, hi=1.0), ints(5, 3, 4, 1)], (0,)),
        ("npair_loss", lambda F, nn, a, b, c: F.npair_loss(a, b, c),
         [r(4, 6), r(4, 6), np.array([0, 1, 0, 2], np.int32)], (0, 1)),
        ("triplet_margin_with_distance_loss",
         lambda F, nn, a, b, c: F.triplet_margin_with_distance_loss(
             a, b, c, swap=True), [r(4, 5), r(4, 5), r(4, 5)], (0, 1, 2)),
        ("ctc_loss", lambda F, nn, *a: F.ctc_loss(*a, reduction="none"),
         ctc, (0,)),
        ("rnnt_loss", lambda F, nn, *a: F.rnnt_loss(
            *a, fastemit_lambda=0.001, reduction="none"), rnnt, (0,)),
        ("softmax_with_cross_entropy",
         lambda F, nn, a, b: F.softmax_with_cross_entropy(a, b),
         [r(4, 5), np.array([[1], [4], [-100], [0]], np.int32)], (0,)),
        ("margin_cross_entropy",
         lambda F, nn, a, b: F.margin_cross_entropy(a, b, reduction="none"),
         [r(4, 6, lo=-0.95, hi=0.95), np.array([0, 3, 5, 1], np.int32)],
         (0,)),
        ("multi_margin_loss",
         lambda F, nn, a, b: F.multi_margin_loss(a, b, p=2),
         [r(4, 5), np.array([0, 4, 2, 2], np.int32)], (0,)),
        ("hsigmoid_loss",
         lambda F, nn, a, b, w, c: F.hsigmoid_loss(a, b, 7, w, c),
         [r(4, 6), np.array([0, 6, 3, 5], np.int32), r(6, 6), r(6, 1)],
         (0, 2, 3)),
        ("gather_tree", lambda F, nn, a, b: F.gather_tree(a, b),
         [ints(9, 4, 2, 3), ints(3, 4, 2, 3)], ()),
        ("sparse_attention",
         lambda F, nn, q, k, v, o, c: F.sparse_attention(q, k, v, o, c),
         [r(1, 2, 4, 8), r(1, 2, 4, 8), r(1, 2, 4, 8), off, cols],
         (0, 1, 2)),
        ("sequence_mask", lambda F, nn, a: F.sequence_mask(a, 6),
         [np.array([2, 0, 5], np.int32)], ()),
        ("Softmax2D", lambda F, nn, a: nn.Softmax2D()(a), [r(2, 3, 4, 4)],
         (0,)),
        ("CTCLoss", lambda F, nn, *a: nn.CTCLoss()(*a), ctc, (0,)),
        ("RNNTLoss", lambda F, nn, *a: nn.RNNTLoss()(*a), rnnt, (0,)),
    ]
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border", "reflection"):
            for align in (True, False):
                rows.append((
                    f"grid_sample_{mode}_{pad}_{int(align)}",
                    lambda F, nn, a, g, m=mode, p=pad, al=align:
                        F.grid_sample(a, g, mode=m, padding_mode=p,
                                      align_corners=al),
                    [r(2, 3, 5, 6), grid], (0, 1) if mode == "bilinear"
                    else (0,)))
    return rows


def zoo_tail_run(torch, np, call, inputs, diff, device):
    """A tail row on ``device``: (outputs, input gradients of ``sum(out
    * w)`` over the float outputs, w from seed 0)."""
    import paddle_tpu_torch as pt
    ts = [torch.tensor(a, device=device) for a in inputs]
    for i in diff:
        ts[i].requires_grad_()
    out = call(pt.nn.functional, pt.nn, *ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if diff:
        rng = np.random.default_rng(0)
        loss = sum((o * torch.tensor(rng.uniform(0.5, 1.5, tuple(o.shape))
                                     .astype(np.float32), device=device)
                    ).sum() for o in outs if o.is_floating_point())
        loss.backward()
    return outs, [ts[i].grad for i in diff]


def phase_zoo_parity(torch, np, card):
    """Phase zoo_parity: the tiny BERT, DiT and Qwen-VL, f32, the card
    against the CPU on one set of weights; QwenVL.generate's tokens; the
    tail's ops and layers; feature_alpha_dropout's mask; beam search."""
    import copy
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as tdevice
    checks = {}
    t_phase = time.perf_counter()
    try:
        models = zoo_tiny_models(torch, np, pt)
        data = zoo_tiny_inputs(np)
        # K4 where the model attends without a mask: BERT's masked
        # forward takes the composition, DiT's second forward (no grad)
        # K4a again, the ViT and the text tower two layers each
        want_k = {"bert": {"k4_fwd": 2, "k4_dq": 2, "k4_dkv": 2},
                  "dit": {"k4_fwd": 4, "k4_dq": 2, "k4_dkv": 2},
                  "vl": {"k4_fwd": 4, "k4_dq": 4, "k4_dkv": 4,
                         "k5_fwd": 5, "k5_bwd": 5, "k6_qk": 4}}
        for name, cpu_m in zip(("bert", "dit", "vl"), models):
            card_m = copy.deepcopy(cpu_m).to("cuda")
            pt.set_device("gpu")
            zero_counts()
            c_out, c_g = zoo_tiny_run(torch, np, name, card_m, data[name],
                                      "cuda")
            torch.cuda.synchronize()
            counts = read_counts()
            pt.set_device("cpu")
            h_out, h_g = zoo_tiny_run(torch, np, name, cpu_m, data[name],
                                      "cpu")
            v_err = {k: nn_scaled_err(torch, c_out[k], h_out[k])
                     for k in h_out}
            gmax = max(g.abs().max().item() for g in h_g.values())
            g_err = {k: nn_scaled_err(torch, c_g[k], g,
                                      NN_GRAD_FLOOR * gmax
                                      if k.endswith(NN_ZERO_GRAD) else 0.0)
                     for k, g in h_g.items()}
            worst = max(g_err, key=g_err.get)
            got_k = {k: counts[k] for k in want_k[name]}
            log(f"zoo_parity {name} tiny [{card}]: "
                f"{sum(p.numel() for p in cpu_m.parameters())} parameters; "
                f"values card against CPU "
                f"{ {k: float(f'{v:.3g}') for k, v in v_err.items()} }; "
                f"largest gradient error {g_err[worst]:.3g} ({worst}) over "
                f"{len(g_err)} tensors; launches {got_k}")
            checks[f"{name}: values within {ZOO_TOL['value']}, gradients "
                   f"within {ZOO_TOL['grad']}"] = \
                max(v_err.values()) <= ZOO_TOL["value"] and \
                g_err[worst] <= ZOO_TOL["grad"] and set(c_g) == set(h_g)
            checks[f"{name}: launches {want_k[name]}"] = \
                got_k == want_k[name]
            if name == "vl":
                ids, px = data["vl"]
                for kw in ({}, {"do_sample": True, "temperature": 0.8,
                                "top_k": 50, "top_p": 0.95, "seed": 7}):
                    toks = []
                    for m, dev in ((card_m, "cuda"), (cpu_m, "cpu")):
                        pt.set_device("gpu" if dev == "cuda" else "cpu")
                        toks.append(m.generate(
                            torch.as_tensor(ids, device=dev),
                            torch.as_tensor(px, device=dev),
                            max_new_tokens=8, **kw).cpu())
                    mode = "sampled" if kw else "greedy"
                    log(f"zoo_parity vl generate {mode}: card "
                        f"{toks[0][:, 12:].tolist()}, equal to the CPU's "
                        f"{torch.equal(*toks)}")
                    checks[f"QwenVL.generate {mode}: card tokens == CPU's"] \
                        = torch.equal(*toks)
            del card_m
        # the tail: every op and layer row, card against CPU
        fails, n_rows = [], 0
        for name, call, inputs, diff in zoo_tail_rows(torch, np):
            n_rows += 1
            try:
                pt.set_device("gpu")
                co, cg = zoo_tail_run(torch, np, call, inputs, diff, "cuda")
                pt.set_device("cpu")
                ho, hg = zoo_tail_run(torch, np, call, inputs, diff, "cpu")
            except Exception as e:       # noqa: BLE001 — reported below
                fails.append(f"{name}: {type(e).__name__}: {e}")
                continue
            if any(o.device.type != "cuda" for o in co):
                fails.append(f"{name}: an output off the card")
            err = max([nn_scaled_err(torch, a.float(), b.float())
                       for a, b in zip(co, ho)] + [0.0])
            gerr = max([nn_scaled_err(torch, a, b, 1e-30)
                        for a, b in zip(cg, hg)] + [0.0])
            if not (err <= ZOO_TOL["value"] and gerr <= ZOO_TOL["op_grad"]):
                fails.append(f"{name}: value {err:.3g}, gradient {gerr:.3g}")
        # host-side ops: numpy's draw on both
        outs = []
        for dev in ("cuda", "cpu"):
            np.random.seed(3)
            outs.append([t.cpu() for t in pt.nn.functional.
                         class_center_sample(torch.tensor(
                             [3, 7, 3, 1, 9, 7], device=dev), 12, 7)])
        n_rows += 1
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            fails.append("class_center_sample: card and CPU differ")
        log(f"zoo_parity tail [{card}]: {n_rows} rows (the tail's ops and "
            f"layers, forward and input gradients), card against CPU; "
            f"fails {fails}")
        checks["every tail row within its tolerance"] = not fails
        # feature_alpha_dropout: R2's uniform fill on the reference's key
        fill0 = read_counts()["r2_fill"]
        masks = []
        for dev in ("cuda", "cpu"):
            pt.set_device("gpu" if dev == "cuda" else "cpu")
            pt.seed(5)
            z = torch.zeros((64, 16, 3), device=dev)
            y = pt.nn.functional.feature_alpha_dropout(z, p=0.3)
            masks.append((y == y.max()).cpu())
        fills = read_counts()["r2_fill"] - fill0
        log(f"zoo_parity feature_alpha_dropout: 64 x 16 channels, p 0.3; "
            f"kept {masks[0].float().mean().item():.4f}; R2 fills {fills}; "
            f"mask equal to the CPU's {torch.equal(*masks)}")
        checks["feature_alpha_dropout: the mask bit for bit the CPU's, one "
               "R2 fill"] = torch.equal(*masks) and fills == 1
        # beam search over a GRU cell (built on the CPU, copied over)
        res = []
        pt.set_device("cpu")
        pt.seed(3)
        parts = (pt.nn.GRUCell(4, 5), pt.nn.Embedding(7, 4),
                 pt.nn.Linear(5, 7))
        for dev in ("cuda", "cpu"):
            pt.set_device("gpu" if dev == "cuda" else "cpu")
            cell, emb, out = (copy.deepcopy(m).to(dev) for m in parts)
            dec = pt.nn.BeamSearchDecoder(cell, 0, 1, 3, embedding_fn=emb,
                                          output_fn=out)
            h0 = pt.to_tensor(np.random.default_rng(1).standard_normal(
                (2, 5)).astype(np.float32))
            ids, lengths = pt.nn.dynamic_decode(dec, inits=h0,
                                                max_step_num=6)
            res.append((ids.numpy(), lengths.numpy()))
        same = all(np.array_equal(a, b) for a, b in zip(*res))
        log(f"zoo_parity dynamic_decode: beam 3 over a GRU cell, ids "
            f"{res[0][0].shape}, equal to the CPU's {same}")
        checks["dynamic_decode: ids and lengths the CPU's"] = same
    finally:
        tdevice._default[0] = None
    log(f"zoo_parity phase {time.perf_counter() - t_phase:.1f} s; checks "
        f"{checks}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"zoo_parity: check failed: {name}")


def zoo_train(torch, np, model, step, steps):
    """2 warm-up steps, then ``steps`` timed with the counters zeroed
    just before and read just after: (losses, ms a step (median),
    launches, peak GiB over the timed steps)."""
    losses = [step() for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    return ([float(x) for x in losses], float(np.median(times)) * 1e3,
            counts, peak_gb)


def phase_zoo(torch, np, card, record, model_7b):
    """Phase zoo: BERT-base pretraining and classification, DiT-S/4
    training and Qwen-VL's forward, loss and generation, at full width in
    bf16 from seed 0."""
    import gc
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch import models as M
    from paddle_tpu_torch.nn import MultiHeadAttention
    from paddle_tpu_torch.optimizer import AdamW
    checks = {}
    steps = ZOO["steps"]
    t_phase = time.perf_counter()
    resident = "with" if model_7b is not None else "without"
    try:
        pt.set_device("gpu")
        # (a) BERT-base pretraining: MLM on 15% of the tokens ([MASK] in
        # their place) and NSP, AdamW(1e-4) under auto_cast bf16
        pt.seed(0)
        cfg = M.bert_base()
        model = M.BertForPretraining(cfg)
        n_params = sum(p.numel() for p in model.parameters())
        B, S = ZOO["bert"]
        rng = np.random.default_rng(0)
        ids = rng.integers(1000, cfg.vocab_size, (B, S))
        picked = rng.random((B, S)) < 0.15
        labels = torch.as_tensor(np.where(picked, ids, -100), device="cuda")
        inputs = torch.as_tensor(np.where(picked, ZOO["mask_id"], ids),
                                 device="cuda")
        types = torch.as_tensor(np.repeat([[0] * (S // 2) + [1] * (S // 2)],
                                          B, 0), device="cuda")
        nsp = torch.as_tensor(rng.integers(0, 2, (B,)), device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        drops = nn_dropout_layers(model) + sum(
            1 for m in model.sublayers()
            if isinstance(m, MultiHeadAttention) and m.dropout > 0)

        def bert_step():
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                mlm, ns = model(inputs, types)
                loss = model.loss(mlm, ns, labels, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        model.train()
        losses, ms, counts, peak_gb = zoo_train(torch, np, model, bert_step,
                                                steps)
        log(f"zoo bert-base pretraining [{card}]: {n_params} parameters, "
            f"{B} x {S} tokens ({int(picked.sum())} masked labels), NSP, "
            f"AdamW(1e-4), auto_cast bf16, dropout 0.1: losses "
            f"{[round(v, 4) for v in losses]}; {ms:.1f} ms a step (median "
            f"of {steps}), {B * S / ms * 1e3:.0f} tokens/s, peak "
            f"{peak_gb:.2f} GiB ({resident} the resident 7B); {drops} "
            f"dropouts a forward; launches over {steps} steps {counts}")
        checks["bert-base: loss finite and falling"] = all(
            math.isfinite(v) for v in losses) and losses[-1] < losses[0]
        checks["bert-base: K4 = 0 (dropout 0.1: the reference's routing)"] = \
            counts["k4_fwd"] == counts["k4_dq"] == counts["k4_dkv"] == 0
        checks[f"bert-base: R2 dropout {steps} x 2 x {drops}, no fill, the "
               f"fused AdamW step {steps} times"] = \
            counts["r2_dropout"] == 2 * drops * steps and \
            counts["r2_fill"] == 0 and counts["opt"] == steps
        record["threefry_fill"]["zoo_launches"] = {
            "bert_base_step": counts["r2_dropout"] // steps}
        profile_once(torch, bert_step, card, "zoo bert-base")
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
        # classification: eval forward at 32 x 128 with padding
        pt.seed(1)
        cls = M.BertForSequenceClassification(cfg)
        cls.eval()
        B, S = ZOO["bert_cls"]
        ids = torch.as_tensor(rng.integers(1000, cfg.vocab_size, (B, S)),
                              device="cuda")
        lengths = rng.integers(S // 2, S + 1, (B,))
        mask = torch.as_tensor(np.arange(S)[None] < lengths[:, None],
                               dtype=torch.int64, device="cuda")
        with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
            cls(ids, attention_mask=mask)
            zero_counts()
            logits = cls(ids, attention_mask=mask)
            torch.cuda.synchronize()
            counts = read_counts()
            cms = event_ms(lambda: cls(ids, attention_mask=mask), torch,
                           iters=10, warmup=1)
        log(f"zoo bert-base classification [{card}]: eval forward {B} x "
            f"{S} with padding (lengths {lengths.min()}..{lengths.max()}), "
            f"auto_cast bf16: {cms:.2f} ms, {B * S / cms * 1e3:.0f} "
            f"tokens/s; logits {tuple(logits.shape)}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        checks["bert-base classification: finite logits [32, 2], no kernel "
               "launch (a mask, eval)"] = \
            tuple(logits.shape) == (B, 2) and \
            bool(torch.isfinite(logits.float()).all()) and \
            not any(counts.values())
        del cls, logits
        gc.collect()
        torch.cuda.empty_cache()
        # (b) DiT-S/4: epsilon prediction at batch 256, AdamW(1e-4)
        pt.seed(0)
        dcfg = M.dit_s_4()
        dit = M.DiTForDiffusion(dcfg)
        n_dit = sum(p.numel() for p in dit.parameters())
        B = ZOO["dit_batch"]
        gen = torch.Generator(device="cuda").manual_seed(0)
        shape = (B, dcfg.in_channels, dcfg.image_size, dcfg.image_size)
        x0 = torch.randn(shape, generator=gen, device="cuda")
        noise = torch.randn(shape, generator=gen, device="cuda")
        tt = torch.randint(0, 1000, (B,), generator=gen, device="cuda")
        yy = torch.randint(0, dcfg.num_classes, (B,), generator=gen,
                           device="cuda")
        dopt = AdamW(learning_rate=1e-4, parameters=dit.parameters())
        L = dcfg.num_layers

        def dit_step():
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = dit.loss(x0, tt, noise, yy)
            loss.backward()
            dopt.step()
            dopt.clear_grad()
            return loss.detach()

        dit.train()
        losses, ms, counts, peak_gb = zoo_train(torch, np, dit, dit_step,
                                                steps)
        log(f"zoo dit-s/4 [{card}]: {n_dit} parameters, batch {B} of "
            f"{shape[1:]} latents ({dcfg.num_patches} tokens, 6 heads of "
            f"64), AdamW(1e-4), auto_cast bf16: losses "
            f"{[round(v, 5) for v in losses]}; {ms:.1f} ms a step (median "
            f"of {steps}), {B / ms * 1e3:.0f} images/s, peak {peak_gb:.2f} "
            f"GiB; launches over {steps} steps {counts}")
        checks["dit-s/4: loss finite and falling"] = all(
            math.isfinite(v) for v in losses) and losses[-1] < losses[0]
        checks[f"dit-s/4: K4a {L}, K4b {L} + {L} a step"] = \
            counts["k4_fwd"] == counts["k4_dq"] == counts["k4_dkv"] == \
            L * steps
        record["flash_attention_fwd"]["zoo_launches"] = {
            "dit_s_4_step": counts["k4_fwd"] // steps}
        record["flash_attention_bwd"]["zoo_launches"] = {
            "dit_s_4_step": counts["k4_dq"] // steps}
        profile_once(torch, dit_step, card, "zoo dit-s/4")
        del dit, dopt, x0, noise
        gc.collect()
        torch.cuda.empty_cache()
        # (c) Qwen-VL: ViT-L/14 at 224 into a Llama-2-7B-wide text model
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pt.seed(0)
        vcfg = M.QwenVLConfig()
        vl = M.QwenVL(vcfg, dtype="bfloat16")
        vl.eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_vl = sum(p.numel() for p in vl.parameters())
        B, T, n_new = ZOO["vl"]
        ids = torch.as_tensor(rng.integers(0, vcfg.text.vocab_size, (B, T)),
                              device="cuda")
        side = vcfg.vision.image_size
        px = torch.randn((B, vcfg.vision.in_channels, side, side),
                         generator=gen, device="cuda").to(torch.bfloat16)
        Lv, Lt = vcfg.vision.num_layers, vcfg.text.num_layers
        with torch.no_grad():
            zero_counts()
            logits = vl(ids, px)
            loss = vl.loss(logits, ids)
            torch.cuda.synchronize()
            counts = read_counts()
            fwd_ms = event_ms(lambda: vl.loss(vl(ids, px), ids), torch,
                              iters=3, warmup=1)
        want = {"k4_fwd": Lv + Lt, "k4_dq": 0, "k4_dkv": 0,
                "k5_fwd": 2 * Lt + 1, "k6_qk": Lt}
        n_vis = vcfg.vision.num_patches
        log(f"zoo qwen-vl [{card}]: {n_vl} parameters in bf16 (built in "
            f"{build_s:.1f} s), {B} images of {side} x {side} ({n_vis} "
            f"visual tokens each) + {T}-token prompts: forward + loss "
            f"{float(loss):.4f}, {fwd_ms:.1f} ms, logits "
            f"{tuple(logits.shape)}; launches {counts}")
        checks[f"qwen-vl forward: K4a {Lv} (the ViT) + {Lt} (the text), "
               f"K5a {2 * Lt + 1}, K6 q + k {Lt}, no backward"] = \
            {k: counts[k] for k in want} == want
        checks["qwen-vl: loss finite, logits [B, visual + text, vocab]"] = \
            math.isfinite(float(loss)) and tuple(logits.shape) == (
                B, n_vis + T, vcfg.text.vocab_size)
        del logits
        gen_res = {}
        for mode, kw in (("greedy", {}),
                         ("sampled", {"do_sample": True, "temperature": 0.8,
                                      "top_k": 50, "top_p": 0.95,
                                      "seed": 0})):
            vl.generate(ids, px, max_new_tokens=2, **kw)        # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vl.generate(ids, px, max_new_tokens=1, **kw)
            torch.cuda.synchronize()
            ttft = (time.perf_counter() - t0) * 1e3
            zero_counts()
            t0 = time.perf_counter()
            out = vl.generate(ids, px, max_new_tokens=n_new, **kw)
            torch.cuda.synchronize()
            full = (time.perf_counter() - t0) * 1e3
            gcounts = read_counts()
            per_tok = (full - ttft) / (n_new - 1)
            gen_res[mode] = out
            record["flash_attention_fwd"]["zoo_launches"][
                f"vit_pass_{mode}"] = gcounts["k4_fwd"]
            log(f"zoo qwen-vl generate {mode} [{card}]: {B} x ({n_vis} "
                f"visual + {T}) -> {n_new} new tokens: time to first token "
                f"{ttft:.1f} ms, {per_tok:.2f} ms a token after it, "
                f"{full:.1f} ms in all; row 0 {out[0, T:T + 8].tolist()}...; "
                f"launches {gcounts}")
            checks[f"qwen-vl generate {mode}: {n_new} tokens a row, the "
                   f"ViT's K4a {Lv}"] = \
                tuple(out.shape) == (B, T + n_new) and \
                bool((out[:, T:] >= 0).all()) and \
                gcounts["k4_fwd"] == Lv and \
                gcounts["r2_fill"] == (n_new if kw else 0)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"zoo qwen-vl [{card}]: peak {peak_gb:.2f} GiB ({resident} the "
            f"resident serve 7B)")
        del vl
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        tdevice._default[0] = None
    log(f"zoo phase {time.perf_counter() - t_phase:.1f} s; checks {checks}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"zoo: check failed: {name}")


def phase_int8_infer(torch, np, card, record, model):
    """Llama-2-7B bf16 (the serve phase's model, or a new one from seed
    0), then converted in place to int8: one forward each of 8 x 512 ids
    from seed 0."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.quantization import to_int8_inference
    cfg = llama2_7b()
    if model is None:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
    L = cfg.num_layers
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 512)), device="cuda")
    tokens = ids.numel()

    def timed(n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model(ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    with torch.no_grad():
        model(ids)                                # warm
        zero_counts()
        ref = model(ids)
        torch.cuda.synchronize()
        c_bf16 = read_counts()
        ms_bf16 = timed()
        profile_once(torch, lambda: model(ids), card, "bf16_infer", "forward")
        t0 = time.perf_counter()
        to_int8_inference(model, inplace=True)
        torch.cuda.synchronize()
        conv_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = model(ids)
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        ms_int8 = timed()
        profile_once(torch, lambda: model(ids), card, "int8_infer", "forward")
    int8_bytes = sum(b.numel() * b.element_size() for b in model.buffers()
                     if b.dtype == torch.int8)
    top1 = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
    rel = ((out.float() - ref.float()).abs().amax(-1)
           / ref.float().abs().amax(-1)).max().item()
    fwd = {"k4_fwd": L, "k5_fwd": 2 * L + 1, "k6_qk": L}
    log(f"int8_infer: Llama-2-7B, {L} layers, 8 x 512 ids from seed 0; "
        f"to_int8_inference in place in {conv_s:.1f} s ({int8_bytes} bytes "
        f"of int8 weights); launches per forward bf16 {c_bf16}, int8 "
        f"{counts}")
    log(f"int8_infer metrics [{card}]: bf16 {ms_bf16:.1f} ms per forward "
        f"({tokens / ms_bf16 * 1e3:.0f} tokens/s), int8 {ms_int8:.1f} ms "
        f"({tokens / ms_int8 * 1e3:.0f} tokens/s), peak memory after the "
        f"conversion {peak_gb:.2f} GiB; int8 against bf16 (informational): "
        f"top-1 agreement {top1:.4f}, largest relative logit error "
        f"{rel:.4f}")
    checks = {"int8 logits finite": torch.isfinite(out).all().item(),
              "k8 == 7 x layers + 1": counts["k8"] == 7 * L + 1,
              "bf16 forward: K4, K5 and K6 forward only, no K8":
                  {k: c_bf16[k] for k in fwd} == fwd and not any(
                      v for k, v in c_bf16.items() if k not in fwd),
              "int8 forward: K8, K4, K5 and K6 forward only":
                  {k: counts[k] for k in fwd} == fwd and not any(
                      v for k, v in counts.items()
                      if k not in fwd and k != "k8")}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"int8_infer: check failed: {name}")
    record["quant_matmul"]["launches"] = counts["k8"]


def run_350m(torch, np, n, count_warmup=False):
    """llama_350m in bf16 from seed 0, AdamW(1e-4), the fixed 8 x 1024
    batch from seed 0: 2 warm-up steps by hand (their gradients checked
    finite), then ``n`` timed ``train_step_fn`` steps. The counters are
    zeroed before the timed steps, or before the warm-up with
    ``count_warmup``, and read after the last step."""
    import gc
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.optimizer import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_350m()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    B, S = 8, 1024
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    batch = {"inputs": (ids,), "labels": (ids,)}
    step = train_step_fn(model, model.loss, opt)
    losses, grads_finite = [], True
    if count_warmup:
        zero_counts()
        vector = rk.rope_qk_fwd.route_launches["vector"]
    for _ in range(2):
        loss = model.loss(model(ids), ids)
        loss.backward()
        grads_finite &= all(torch.isfinite(p.grad).all().item()
                            for p in model.parameters())
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if not count_warmup:
        zero_counts()
        vector = rk.rope_qk_fwd.route_launches["vector"]
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    counts["k6_qk_vector"] = rk.rope_qk_fwd.route_launches["vector"] - vector
    losses = [x.item() for x in losses]
    finite = all(np.isfinite(losses)) and all(
        torch.isfinite(p).all().item() for p in model.parameters())
    return {"cfg": cfg, "model": model, "step": step, "batch": batch,
            "losses": losses, "counts": counts, "wall": wall,
            "step_ms": wall / n * 1e3, "tok_s": B * S * n / wall,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "finite": finite and grads_finite,
            "n_params": sum(p.numel() for p in model.parameters())}


def phase_train(torch, np, card, peak, record):
    n = 10
    r = run_350m(torch, np, n)
    cfg, counts, losses = r["cfg"], r["counts"], r["losses"]
    L, B, S = cfg.num_layers, 8, 1024
    log(f"train: llama_350m bf16, {L} layers, {r['n_params']} parameters, "
        f"AdamW(1e-4) f32 moments, batch {B} x {S} from seed 0")
    want = per_step_counts(L, n)
    flops = 6 * r["n_params"] * B * S + 3 * 2 * B * cfg.num_heads * S * S \
        * cfg.head_dim * L
    per_step_s = r["wall"] / n
    log(f"train losses: {[round(x, 4) for x in losses]}")
    log(f"train metrics [{card}]: {r['step_ms']:.1f} ms per step, "
        f"{r['tok_s']:.0f} tokens/s, peak memory {r['peak_gb']:.2f} GiB, "
        f"{flops / per_step_s / 1e12:.1f} model TFLOP/s "
        f"({100 * flops / per_step_s / peak[1]:.1f}% of the bf16 peak)")
    log(f"train launches over {n} steps: {counts}")
    checks = {"loss falls": losses[-1] < losses[0],
              "losses, weights and warm-up gradients finite": r["finite"],
              "launches == steps x per-step counts (K6: q + k, 2 x layers)":
                  {k: counts[k] for k in want} == want,
              "K6 on the vector route":
                  counts["k6_qk_vector"] == counts["k6_qk"],
              "no serving, epilogue or int8 kernel":
                  not any(counts[k] for k in ("k1", "k2", "k3", "k7", "k8"))}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"train: check failed: {name}")
    record["flash_attention_fwd"]["launches"] = counts["k4_fwd"]
    record["flash_attention_bwd"]["launches"] = counts["k4_dq"]
    record["rms_norm_fwd"]["launches"] = counts["k5_fwd"]
    record["rms_norm_bwd"]["launches"] = counts["k5_bwd"]
    record["rope"]["launches"] = counts["k6"] + counts["k6_qk"]
    profile_once(torch, lambda: r["step"](r["batch"]), card)
    return {"losses": losses, "step_ms": r["step_ms"]}


def phase_train_compose(torch, np, card, train):
    """The train phase's run with rope on the composition: the same
    losses bit for bit (K6 is the composition bit for bit, forward and
    backward), and the step time beside train's from this call."""
    n = 5
    with rope_composition():
        r = run_350m(torch, np, n, count_warmup=True)
        profile_once(torch, lambda: r["step"](r["batch"]), card,
                     "train_compose")
    counts, losses = r["counts"], r["losses"]
    L = r["cfg"].num_layers
    steps = n + 2
    want = per_step_counts(L, steps, rope=False)
    ref = train["losses"][:steps]
    log(f"train_compose losses: {[round(x, 4) for x in losses]}; the train "
        f"phase's first {steps}: {[round(x, 4) for x in ref]}; bit for bit "
        f"equal {losses == ref}")
    log(f"train_compose metrics [{card}]: {r['step_ms']:.1f} ms per step "
        f"with the composition rope, {train['step_ms']:.1f} ms with K6 (the "
        f"train phase), {r['tok_s']:.0f} tokens/s, peak memory "
        f"{r['peak_gb']:.2f} GiB; launches over {steps} steps: {counts}")
    checks = {"losses equal train's bit for bit": losses == ref,
              "losses, weights and warm-up gradients finite": r["finite"],
              "launches == steps x per-step counts (no K6)":
                  {k: counts[k] for k in want} == want,
              "no serving, epilogue or int8 kernel":
                  not any(counts[k] for k in ("k1", "k2", "k3", "k7",
                                              "k8"))}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"train_compose: check failed: {name}")


def phase_train_amp(torch, np, card, record):
    """The slice's path: llama_350m at full width and depth, cast by
    amp.decorate(O2, bf16) (the rope tables stay f32), AdamW with f32
    masters, decay off the norms and ClipGradByGlobalNorm(1.0) on the
    fused kernel, lr from LinearWarmup(CosineAnnealingDecay(3e-4, 100),
    5 steps from 0), 12 train_step_fn steps under auto_cast(O2, bf16) on
    the fixed 8 x 1024 batch, the first one by hand to hold the clip
    against the plain global norm. Then f32 parameters under O1 with a
    GradScaler: an injected inf gradient skips its step."""
    import gc
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.clip import _global_scale, _sq_sum
    from paddle_tpu_torch.ops.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lrs
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_350m()
    L, B, S, n = cfg.num_layers, 8, 1024, 12
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    amp.decorate(model, level="O2", dtype="bfloat16")
    attn = model.model.layers[0].self_attn
    cast_ok = all(p.dtype == torch.bfloat16 for p in model.parameters()) \
        and attn.rope_cos.dtype == torch.float32
    sched = lrs.LinearWarmup(lrs.CosineAnnealingDecay(3e-4, T_max=100),
                             warmup_steps=5, start_lr=0.0, end_lr=3e-4)
    clip = ClipGradByGlobalNorm(1.0)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True, grad_clip=clip,
                apply_decay_param_fun=lambda name: "norm" not in name)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    batch = {"inputs": (ids,), "labels": (ids,)}
    step = train_step_fn(model, model.loss, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    k5 = (dict(rn.rms_norm_fwd.dtype_launches),
          dict(rn.rms_norm_bwd.dtype_launches))
    vector = rk.rope_qk_fwd.route_launches["vector"]
    lrs_seen, infos, losses = [], [], []
    t0 = time.perf_counter()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        # step 1 by hand: the plain global norm of its gradients
        loss = model.loss(model(ids), ids)
        loss.backward()
        ref_scale, ref_gn = _global_scale(
            _sq_sum([p.grad for p in model.parameters()]), clip.clip_norm)
        lrs_seen.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss.detach())
        infos.append(opt._clip_info)
        for _ in range(n - 1):
            lrs_seen.append(opt.get_lr())
            losses.append(step(batch))
            infos.append(opt._clip_info)
            sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    counts["k6_qk_vector"] = rk.rope_qk_fwd.route_launches["vector"] - vector
    k5_f32 = (rn.rms_norm_fwd.dtype_launches["float32"] - k5[0]["float32"],
              rn.rms_norm_bwd.dtype_launches["float32"] - k5[1]["float32"])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [x.item() for x in losses]
    infos = [x.tolist() for x in infos]
    ks, kg = infos[0]
    masters = opt.state_dict()["state"]["master"].values()
    finite = all(np.isfinite(losses)) and all(
        torch.isfinite(p).all().item() for p in model.parameters()) and all(
        torch.isfinite(m).all().item() for m in masters)
    n_tensors = len(list(model.parameters()))
    want = per_step_counts(L, n, opt_kernels=mta.kernels_per_step(
        n_tensors, True))
    log(f"train_amp: llama_350m O2 bf16 (decorate; rope tables f32 "
        f"{attn.rope_cos.dtype}), AdamW multi_precision, decay 0.01 off the "
        f"norms, ClipGradByGlobalNorm(1.0), LinearWarmup(CosineAnnealing"
        f"Decay(3e-4, 100), 5 steps); {n} steps on {B} x {S}")
    log(f"train_amp losses: {[round(x, 4) for x in losses]}")
    log(f"train_amp lr: {lrs_seen}")
    log(f"train_amp clip: step 1 scale {ks!r}, norm {kg!r} (plain "
        f"{ref_scale.item()!r}, {ref_gn.item()!r}); scales "
        f"{[round(i[0], 6) for i in infos]}")
    log(f"train_amp metrics [{card}]: {wall / n * 1e3:.1f} ms per step, "
        f"{B * S * n / wall:.0f} tokens/s, peak memory {peak_gb:.2f} GiB; "
        f"launches over {n} steps {counts}, K5 on its f32 route {k5_f32}")
    checks = {
        "parameters bf16, rope tables f32": cast_ok,
        "loss falls": losses[-1] < losses[0],
        "losses, parameters and masters finite": finite,
        "lr each step == the scheduler's get_lr_at":
            lrs_seen == [sched.get_lr_at(i) for i in range(n)],
        "clip scale <= 1 and within 4 f32 ulps of the plain one":
            all(i[0] <= 1.0 for i in infos) and abs(ks - ref_scale.item())
            <= 4 * np.spacing(np.float32(ref_scale.item()))
            and abs(kg - ref_gn.item()) <= 1e-6 * ref_gn.item(),
        "launches == steps x (K4, K5, K6 q + k, the optimizer kernel)":
            {k: counts[k] for k in want} == want,
        "K5 on its f32 route": k5_f32 == (want["k5_fwd"], want["k5_bwd"]),
        "K6 on the vector route": counts["k6_qk_vector"] == counts["k6_qk"],
        "no serving, epilogue or int8 kernel":
            not any(counts[k] for k in ("k1", "k2", "k3", "k7", "k8"))}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"train_amp: check failed: {name}")
    record["multi_tensor_adam"]["launches"] = counts["opt"]
    record["multi_tensor_adam"]["kernel_launches"] = counts["opt_kernels"]

    def one():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            step(batch)

    profile_once(torch, one, card, "train_amp")
    del model, opt, step
    train_amp_scaler(torch, np, card)


def train_amp_scaler(torch, np, card):
    """f32 llama_350m under auto_cast(O1, bf16) with
    GradScaler(2**15, decr_every_n_nan_or_inf=1) and AdamW(1e-4) on the
    kernel: 3 steps, the second with an inf written into one gradient.
    That step is skipped (parameters unchanged bit for bit, the optimizer
    not stepped) and the scale halves; the other two update."""
    import gc
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    from paddle_tpu_torch.optimizer import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_350m()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15,
                            decr_every_n_nan_or_inf=1)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 1024)), device="cuda")
    snaps, scales, losses, stepped = [], [], [], []
    for i in range(3):
        before = [p.detach().clone() for p in model.parameters()]
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model.loss(model(ids), ids)
        scaler.scale(loss).backward()
        if i == 1:
            model.lm_head.weight.grad[0, 0] = float("inf")
        count = opt.state_dict()["step"]
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        stepped.append(opt.state_dict()["step"] > count)
        snaps.append(all(torch.equal(a, p) for a, p in
                         zip(before, model.parameters())))
        scales.append(scaler.get_init_loss_scaling())
        losses.append(loss.item())
    log(f"train_amp scaler [{card}]: f32 llama_350m under O1, losses "
        f"{[round(x, 4) for x in losses]}, scale after each step {scales}, "
        f"optimizer stepped {stepped}, parameters unchanged {snaps}")
    ok = stepped == [True, False, True] and snaps == [False, True, False] \
        and scales == [2.0 ** 15, 2.0 ** 14, 2.0 ** 14] \
        and all(np.isfinite(losses))
    if not ok:
        raise SystemExit("train_amp: the GradScaler did not skip the inf "
                         "step, or did not halve its scale")


class FitRecorder:
    """A ``hapi`` callback that keeps each step's loss and the host
    clock at each batch's begin and end (``fit`` reads the loss as a
    float at the end of every step, so an end time is the step's end
    on the card). ``hook(n)`` runs after the n-th step; ``around(it,
    when)`` at a batch's begin and end."""

    def __init__(self, hook=None, around=None):
        self.losses, self.begins, self.ends = [], [], []
        self.hook, self.around = hook, around

    def set_model(self, model):
        self.model = model

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_begin(self, logs=None):
        self.start = time.perf_counter()

    def on_train_batch_begin(self, step, logs=None):
        self.begins.append(time.perf_counter())
        if self.around is not None:
            self.around(step, "begin")

    def on_train_batch_end(self, step, logs=None):
        self.ends.append(time.perf_counter())
        self.losses.append(logs["loss"])
        if self.around is not None:
            self.around(step, "end")
        if self.hook is not None:
            self.hook(len(self.losses))


def timed_store(sup, saves):
    """Time every save of ``sup``'s store into ``saves``: (step,
    seconds, bytes of the checkpoint's files)."""
    store, save = sup.store, sup.store.save

    def timed(step, state, meta=None):
        t0 = time.perf_counter()
        path = save(step, state, meta)
        dt = time.perf_counter() - t0
        with open(os.path.join(path, "manifest.json")) as f:
            nbytes = sum(e["bytes"] for e in json.load(f)["files"].values())
        saves.append((int(step), dt, nbytes))
        return path

    store.save = timed
    return sup


def state_snapshot(torch, model):
    """Clones of a Model's parameters and optimizer state, by name."""
    snap = {("p", n): t.detach().clone() for n, t in model._params.items()}
    for sname, tree in model._opt_state.items():
        snap.update({(sname, n): t.clone() for n, t in tree.items()})
    return snap


def guard_flags(torch, tensors):
    """The guarded step's finiteness flag (``hapi.model._all_finite``,
    one multi-tensor pass) on card tensors: true on finite ones, false
    with a NaN, an Inf or a -Inf planted in the last element of the
    first, a middle or the last tensor, each restored after."""
    from paddle_tpu_torch.hapi.model import _all_finite
    seen = [_all_finite(tensors).item()]
    for i in (0, len(tensors) // 2, len(tensors) - 1):
        flat = tensors[i].view(-1)
        old = flat[-1].clone()
        for bad in (float("nan"), float("inf"), float("-inf")):
            flat[-1] = bad
            seen.append(not _all_finite(tensors).item())
        flat[-1] = old
    seen.append(_all_finite(tensors).item())
    log(f"fit guard: flags {seen} (all must be True)")
    return all(seen)


def fit_breakdown(torch, np, model, data, card):
    """Where a fit step's time goes beyond the train step's, on the
    trained model of run A (it takes further steps): the guarded step
    (finiteness flags read before the update) and the plain step, each
    ended by the loss read as fit reads it, median of 5; the key split
    and the batch's move to the card on the host; a profile of one
    guarded step."""
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.io import DataLoader
    batch = next(iter(DataLoader(data, batch_size=8)))
    inputs, labels = model._split(batch)

    def median_ms(fn, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    def step(fn):
        def run():
            model._step_count += 1
            sub = prng.split(prng.PRNGKey(model._step_count))[1]
            out = fn(inputs, labels, model._step_count, sub,
                     model._cur_lr())
            float(out[0] if isinstance(out, tuple) else out)
        return run

    guarded = median_ms(step(model._gstep_fn))
    plain = median_ms(step(model._step_fn))
    split = median_ms(lambda: prng.split(prng.PRNGKey(1)), 20)
    move = median_ms(lambda: model._split(batch), 20)
    log(f"fit step [{card}]: guarded {guarded:.1f} ms, plain {plain:.1f} "
        f"ms (each ended by the loss read), key split {split:.3f} ms, "
        f"batch to the card {move:.3f} ms (host clock, median)")
    profile_once(torch, step(model._gstep_fn), card, "fit")


# runs A and C of the fit phase save only at their end (their 12 and 7
# steps stay under it); B saves at its preemption
FIT_INTERVAL = 100
FIT_LAYERS = 12          # of llama_350m's 24: the saves' time follows it


def phase_fit(torch, np, card, record, train):
    """This slice's path: ``Model.fit`` under ``TrainSupervisor`` on
    llama_350m at full width and ``FIT_LAYERS`` of its layers in bf16,
    seed 0, AdamW(1e-4, weight_decay=0.01), ``nn.CrossEntropyLoss()``, a
    ``TensorDataset`` of 96 seeded rows of 1025 ids (inputs the first
    1024, labels the last 1024), batch 8 (12 batches), 2 fork workers,
    a checkpoint at each run's end (and B's preemption), keeping 1, in a
    temporary directory (one 4.5 GB save a run: the step interval that
    saved A and C twice more was cut to make room for later phases).
    A: one uninterrupted epoch; B: the same, preempted after step 5;
    C: a fresh model and supervisor over B's directory, resuming it; D:
    3 batches with a NaN loss at step 2; E: evaluate over 2 batches; F:
    Model.save and Model.load."""
    import gc
    import shutil
    import tempfile
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.reliability import TrainSupervisor
    from paddle_tpu_torch.telemetry import MetricRegistry, TelemetryCallback
    cfg = dataclasses.replace(llama_350m(), num_layers=FIT_LAYERS)
    L, B, S, N = cfg.num_layers, 8, 1024, 96
    steps = N // B
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size, (N, S + 1))
    data = TensorDataset([rows[:, :S], rows[:, 1:]])

    def make(seed=0, loss=None):
        gc.collect()
        torch.cuda.empty_cache()
        net = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                               seed=seed)
        return Model(net).prepare(
            optimizer=AdamW(1e-4, parameters=net.named_parameters(),
                            weight_decay=0.01),
            loss=loss or CrossEntropyLoss())

    def run(model, sup, rec, ds=data, extra=()):
        zero_counts()
        vector = rk.rope_qk_fwd.route_launches["vector"]
        t0 = time.perf_counter()
        model.fit(ds, batch_size=B, epochs=1, verbose=0, num_workers=2,
                  callbacks=[rec, *extra], supervisor=sup)
        torch.cuda.synchronize()
        counts = read_counts()
        counts["k6_qk_vector"] = \
            rk.rope_qk_fwd.route_launches["vector"] - vector
        return counts, time.perf_counter() - t0

    def launched(tag, counts, n, committed):
        want = per_step_counts(L, n)
        want.update(opt=committed, opt_kernels=committed)
        quiet = ("k1", "k2", "k3", "k6", "k7", "k8", "r1", "r2_dropout",
                 "r2_fill")
        good = {k: counts[k] for k in want} == want and \
            counts["k6_qk_vector"] == counts["k6_qk"] and \
            not any(counts[k] for k in quiet)
        log(f"fit {tag}: launches {counts}; want {want}, no other kernel: "
            f"{good}")
        return good

    root = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    checks = {}
    t_phase = time.perf_counter()
    try:
        # A: the uninterrupted run, the counters zeroed just before, with
        # the telemetry callback and a registry on the supervisor (and
        # its checkpoint store)
        saves = []
        model = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec_a = FitRecorder()
        reg = MetricRegistry()
        counts, wall_a = run(model, timed_store(TrainSupervisor(
            os.path.join(root, "a"), save_interval_steps=FIT_INTERVAL,
            max_to_keep=1, registry=reg), saves), rec_a,
            extra=[TelemetryCallback(reg, tokens_per_batch=B * S)])
        snap = reg.snapshot()
        tel = {"steps": snap["train_step_seconds"]["samples"][()]["count"],
               "steps_total": snap["train_steps_total"]["samples"][()],
               "tokens_total": snap["train_tokens_total"]["samples"][()],
               "saves": snap["ckpt_save_seconds"]["samples"][()]["count"],
               "last_good": snap["ckpt_last_good_step"]["samples"][()],
               "loss": snap["train_loss"]["samples"][()],
               "tokens_s": snap["train_throughput"]["samples"][()]}
        log(f"fit A telemetry [{card}]: {tel}")
        checks["A: the step histogram counts 12 steps, the registry every "
               "checkpoint save (one), the last good step 12"] = \
            len(saves) == 1 and \
            tel["steps"] == tel["steps_total"] == steps and \
            tel["tokens_total"] == steps * B * S and \
            tel["saves"] == len(saves) > 0 and tel["last_good"] == steps
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        checks["A: launches == 12 x the train step's, fused step 12"] = \
            launched("A", counts, steps, steps)
        record["flash_attention_fwd"]["launches"] = counts["k4_fwd"]
        record["flash_attention_bwd"]["launches"] = counts["k4_dq"]
        record["rms_norm_fwd"]["launches"] = counts["k5_fwd"]
        record["rms_norm_bwd"]["launches"] = counts["k5_bwd"]
        record["rope"]["launches"] = counts["k6"] + counts["k6_qk"]
        record["multi_tensor_adam"]["launches"] = counts["opt"]
        final_a = [p.detach().clone() for p in model.network.parameters()]
        checks[f"the guard flags a NaN, an Inf and a -Inf in one of "
               f"{len(final_a)} bf16 tensors, and nothing in finite "
               f"ones"] = \
            guard_flags(torch, final_a)
        fit_breakdown(torch, np, model, data, card)
        del model
        shutil.rmtree(os.path.join(root, "a"), ignore_errors=True)
        saved = {s for s, _, _ in saves}
        step_s = [(i + 1, rec_a.ends[i] - rec_a.ends[i - 1])
                  for i in range(1, len(rec_a.ends))]
        steady = [dt for n, dt in step_s if n not in saved]
        step_ms = float(np.median(steady)) * 1e3
        waits = [rec_a.begins[i] - rec_a.ends[i - 1]
                 for i in range(1, len(rec_a.begins))]
        log(f"fit A losses: {rec_a.losses}")
        train_ms = (f"{train['step_ms']:.1f} ms at 24 layers"
                    if train is not None
                    else "not measured (run the train phase)")
        log(f"fit metrics [{card}]: llama_350m bf16, {L} layers, batch {B} "
            f"x {S}: {step_ms:.1f} ms per step (median of {len(steady)} "
            f"steady steps, checkpoint steps {sorted(saved)} excluded; "
            f"the train phase's step in this call: {train_ms}), "
            f"{B * S / step_ms * 1e3:.0f} tokens/s, peak memory "
            f"{peak_gb:.2f} GiB, loader wait {np.median(waits) * 1e3:.3f} "
            f"ms per step (median, max {max(waits) * 1e3:.3f} ms), run A "
            f"{wall_a:.1f} s wall")
        log(f"fit A step times (ms): "
            f"{[round(dt * 1e3, 1) for _, dt in step_s]}")

        # B: preempted after step 5; C: a fresh model resumes it
        d = os.path.join(root, "bc")
        sup_b = TrainSupervisor(d, save_interval_steps=6, max_to_keep=1)
        rec_b = FitRecorder(hook=lambda n: n == 5
                            and sup_b.request_preemption())
        model = make()
        counts, _ = run(model, timed_store(sup_b, saves), rec_b)
        checks["B: preempted after 5 steps, launches 5 x"] = \
            len(rec_b.losses) == 5 and model.stop_training and \
            launched("B", counts, 5, 5)
        del model
        model = make()
        rec_c = FitRecorder()
        sup_c = TrainSupervisor(d, save_interval_steps=FIT_INTERVAL,
                                max_to_keep=1)
        restore = sup_c.store.restore
        restores = []

        def timed_restore(step=None):
            t0 = time.perf_counter()
            out = restore(step)
            restores.append(time.perf_counter() - t0)
            return out

        sup_c.store.restore = timed_restore
        counts, _ = run(model, timed_store(sup_c, saves), rec_c)
        checks["C: launches 7 x"] = launched("C", counts, steps - 5,
                                             steps - 5)
        log(f"fit B losses {rec_b.losses} + C losses {rec_c.losses}; A's "
            f"{rec_a.losses}")
        for tag, (step, dt, nbytes) in zip("ABC", saves):
            log(f"fit checkpoint [{card}]: run {tag} step {step}, "
                f"{nbytes / 1e9:.3f} GB in {dt:.2f} s, "
                f"{nbytes / 1e9 / dt:.2f} GB/s")
        log(f"fit checkpoint [{card}]: run C restored step 5 in "
            f"{restores[0]:.2f} s")
        checks["B + C losses == A's, bit for bit"] = \
            rec_b.losses + rec_c.losses == rec_a.losses
        checks["C's final parameters == A's, bit for bit"] = all(
            torch.equal(a, b) for a, b in zip(final_a,
                                              model.network.parameters()))
        del final_a
        shutil.rmtree(d, ignore_errors=True)

        # E: evaluate over 2 batches on C's model
        zero_counts()
        res = model.evaluate(data, batch_size=B, num_iters=2)
        counts = read_counts()
        want = {"k4_fwd": 2 * L, "k4_dq": 0, "k4_dkv": 0,
                "k5_fwd": 2 * (2 * L + 1), "k5_bwd": 0, "k6_qk": 2 * L,
                "opt": 0}
        log(f"fit E: evaluate {res}, launches {counts}")
        checks["E: evaluate loss finite, forward launches only"] = \
            bool(np.isfinite(res["loss"][0])) and \
            {k: counts[k] for k in want} == want

        # F: Model.save and Model.load round-trip
        path = os.path.join(root, "model")
        t0 = time.perf_counter()
        model.save(path)
        t_save = time.perf_counter() - t0
        other = make(seed=1)
        t0 = time.perf_counter()
        other.load(path)
        t_load = time.perf_counter() - t0
        checks["F: loaded parameters == saved, bit for bit"] = all(
            torch.equal(a, b) for a, b in zip(model.network.parameters(),
                                              other.network.parameters()))
        log(f"fit F: Model.save {t_save:.2f} s "
            f"({os.path.getsize(path + '.pdparams') / 1e9:.3f} GB params, "
            f"{os.path.getsize(path + '.pdopt') / 1e9:.3f} GB optimizer), "
            f"Model.load {t_load:.2f} s")
        del model, other

        # D: 3 batches, a NaN loss at step 2: skipped, the state unchanged
        ce = CrossEntropyLoss()
        calls = [0]

        def nan_at_2(out, label):
            calls[0] += 1
            loss = ce(out, label)
            return loss * float("nan") if calls[0] == 2 else loss

        model = make(loss=nan_at_2)
        held = {}

        def around(it, when):
            if it != 1:
                return
            if when == "begin":
                held["state"] = state_snapshot(torch, model)
                held["count"] = model._step_count
                return
            after = state_snapshot(torch, model)
            held["same"] = all(torch.equal(after[k], v)
                               for k, v in held["state"].items())
            held["advanced"] = model._step_count == held["count"] + 1
            del held["state"]

        sup_d = TrainSupervisor(os.path.join(root, "d"),
                                save_interval_steps=100, max_to_keep=1)
        rec_d = FitRecorder(around=around)
        counts, _ = run(model, sup_d, rec_d, TensorDataset(
            [rows[:3 * B, :S], rows[:3 * B, 1:]]))
        log(f"fit D losses {rec_d.losses}; anomalies {sup_d.anomalies}; "
            f"state unchanged across the NaN step {held.get('same')}, step "
            f"count advanced {held.get('advanced')}")
        checks["D: NaN step skipped, state unchanged bit for bit, count "
               "advanced, fused step 2 of 3"] = \
            held.get("same") is True and held.get("advanced") is True and \
            sup_d.anomalies == 1 and launched("D", counts, 3, 2) and \
            not np.isfinite(rec_d.losses[1]) and \
            all(np.isfinite([rec_d.losses[0], rec_d.losses[2]]))
        del model
        losses = rec_a.losses + rec_b.losses + rec_c.losses
        checks["losses finite, the loss falls"] = \
            all(np.isfinite(losses)) and rec_a.losses[-1] < rec_a.losses[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"fit: phase {time.perf_counter() - t_phase:.1f} s wall; checks "
        f"{checks}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"fit: check failed: {name}")



# ------------------------------------------------------------ static_jit

# (a)'s static stack: llama_350m's widths and depth (models.llama.
# llama_350m: hidden 1024, 16 heads of 64, intermediate 2816, 24 layers)
STATIC_STACK = {"B": 8, "S": 1024, "hidden": 1024, "heads": 16,
                "inter": 2816, "layers": 24, "runs": 3}


def custom_op_counts(prog):
    """{custom op: calls} in a loaded archive's graph."""
    counts = {}
    for node in prog.program.graph.nodes:
        name = str(node.target)
        if name.startswith("paddle_tpu_torch."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def sync_ms(torch, fn):
    """(fn's result, its ms on the host's clock ended by a sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def static_jit_stack(torch, np, pt, card, root, checks):
    """(a): the static stack at llama_350m's width and depth, trained by
    three Executor runs against the same stack run eagerly, then its
    inference archive against the Executor's ``for_test`` fetch."""
    import paddle_tpu_torch.static as st
    c = STATIC_STACK
    B, S, H, heads, inter, L = (c["B"], c["S"], c["hidden"], c["heads"],
                                c["inter"], c["layers"])
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = stack_shapes(H, inter)
    init = [{k: torch.ones(shapes[k], dtype=bf16, device="cuda")
             if k.startswith("ln") else
             (torch.randn(shapes[k], generator=gen, device="cuda")
              * 0.02).to(bf16) for k in STACK_PARAMS} for _ in range(L)]
    x = (torch.randn((B, S, H), generator=gen, device="cuda")).to(bf16)
    pt.seed(0)
    zero_counts()
    (main, startup, xv, loss, _), build_ms = sync_ms(
        torch, lambda: static_stack(pt, B, S, H, heads, inter, L,
                                    "bfloat16", init))
    built = read_counts()
    # a second build of the same program: the first one's time is mostly
    # torch's imports on first use (dynamo, sympy), paid once a process
    zero_counts()
    _, warm_build_ms = sync_ms(torch, lambda: static_stack(
        pt, B, S, H, heads, inter, L, "bfloat16", init))
    built2 = read_counts()
    exe = st.Executor()
    exe.run(startup)
    start = {n: st.global_scope()._vars[n].clone()
             for n in main._param_names}
    torch.cuda.reset_peak_memory_stats()
    losses, run_ms, run_counts = [], [], []
    for _ in range(c["runs"]):
        zero_counts()
        (lv,), ms = sync_ms(torch, lambda: exe.run(
            main, feed={"x": x}, fetch_list=[loss], return_numpy=False))
        run_counts.append(read_counts())
        losses.append(lv)
        run_ms.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    weights = [{k: start[f"stack{i}_{k}"] for k in STACK_PARAMS}
               for i in range(L)]
    del start
    eager, eager_ms = sync_ms(torch, lambda: eager_stack(
        pt, torch, weights, x, heads, c["runs"]))
    del weights
    want = {"k5_fwd": 2 * L, "k4_fwd": L, "k4_dq": L, "k4_dkv": L,
            "k5_bwd": 2 * L, "opt": 1, "opt_kernels": 1}
    checks["(a) building the program launched nothing"] = \
        not any(built.values()) and not any(built2.values())
    checks["(a) each run's loss = the eager stack's, bitwise"] = all(
        torch.equal(a, b) for a, b in zip(losses, eager))
    checks["(a) the loss falls"] = float(losses[-1]) < float(losses[0])
    checks[f"(a) launches a run K5a {2 * L}, K4a {L}, K4b {L} + {L}, "
           f"K5b {2 * L}, the fused AdamW 1, no other kernel"] = all(
        {k: v for k, v in rc.items() if v} == want for rc in run_counts)
    log(f"static_jit (a) [{card}]: {L} blocks at llama_350m's widths ({H} "
        f"hidden, {heads} heads of {H // heads}, {inter} intermediate), "
        f"bf16, {B} x {S}; {main.num_ops} ops, {len(main._param_names)} "
        f"parameters; built in {build_ms:.1f} ms (again "
        f"{warm_build_ms:.1f} ms), launches while building "
        f"{ {k: v for k, v in built.items() if v} }; losses "
        f"{[float(v) for v in losses]} (eager "
        f"{[float(v) for v in eager]}, {eager_ms / c['runs']:.2f} ms a "
        f"step); ms per Executor.run {[round(v, 2) for v in run_ms]}; peak "
        f"{peak:.2f} GiB; launches "
        f"a run {[{k: v for k, v in rc.items() if v} for rc in run_counts]}")
    # the inference archive of the for_test program
    test = main.clone(for_test=True)
    zero_counts()
    (fetched,), test_ms = sync_ms(torch, lambda: exe.run(
        test, feed={"x": x}, fetch_list=[loss], return_numpy=False))
    test_counts = read_counts()
    prefix = os.path.join(root, "stack", "infer")
    _, export_ms = sync_ms(torch, lambda: st.save_inference_model(
        prefix, [xv], [loss], exe, program=test))
    (prog, _f, _o), load_ms = sync_ms(
        torch, lambda: st.load_inference_model(prefix, exe))
    zero_counts()
    (out,), arch_ms = sync_ms(torch, lambda: prog(x))
    arch_counts = read_counts()
    ops = custom_op_counts(prog)
    mb = os.path.getsize(prefix + ".pdmodel") / 2 ** 20
    fwd = {"k5_fwd": 2 * L, "k4_fwd": L}
    checks["(a) the archive = the Executor's for_test fetch, bitwise"] = \
        torch.equal(out, fetched)
    checks[f"(a) the archive's launches K4a {L}, K5a {2 * L} through the "
           "custom ops, no other kernel"] = (
        {k: v for k, v in arch_counts.items() if v} == fwd
        and ops.get("flash_fwd") == L and ops.get("rms_norm_fwd") == 2 * L)
    checks["(a) the for_test run's launches K4a, K5a only"] = \
        {k: v for k, v in test_counts.items() if v} == fwd
    log(f"static_jit (a) archive [{card}]: for_test run {test_ms:.2f} ms, "
        f"loss {float(fetched):.6f}; export {export_ms / 1e3:.2f} s, load "
        f"{load_ms / 1e3:.2f} s, archive {mb:.1f} MiB, run "
        f"{arch_ms:.2f} ms; custom ops {ops}; launches "
        f"{ {k: v for k, v in arch_counts.items() if v} }")
    return {"run_counts": run_counts[-1], "arch_counts": arch_counts}


def static_jit_llama(torch, np, pt, card, root, checks):
    """(b): ``to_static``, ``grad_and_loss`` and ``jit.save`` /
    ``jit.load`` on ``LlamaForCausalLM(llama_350m())`` at 8 x 1024."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    from paddle_tpu_torch.static import InputSpec
    cfg = llama_350m()
    L = cfg.num_layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    B, S = 8, 1024
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    with torch.no_grad():
        eager = model(ids)
    ts = pt.jit.to_static(model)
    ts(ids)                                        # warm-up
    zero_counts()
    got, fwd_ms = sync_ms(torch, lambda: ts(ids))
    fwd_counts = read_counts()
    fwd_ms2 = sync_ms(torch, lambda: ts(ids))[1]
    checks["(b) to_static's logits = eager, bitwise"] = \
        torch.equal(got.value, eager)
    want = {"k5_fwd": 2 * L + 1, "k4_fwd": L, "k6_qk": L}
    checks[f"(b) to_static launches K4a {L}, K5a {2 * L + 1}, K6 {L} "
           "(q + k), no other kernel"] = \
        {k: v for k, v in fwd_counts.items() if v} == want
    del got

    def loss_fn(logits):
        return model.loss(logits, ids)

    params = {n: p for n, p in model.named_parameters()}
    vg = pt.jit.grad_and_loss(model, loss_fn)
    zero_counts()
    (loss, grads), step_ms = sync_ms(torch, lambda: vg(params, (ids,)))
    step_counts = read_counts()
    model.zero_grad(set_to_none=True)
    el = loss_fn(model(ids))
    el.backward()
    same = all(torch.equal(p.grad, grads[n]) for n, p in
               model.named_parameters())
    checks["(b) grad_and_loss's loss and gradients = eager autograd's, "
           "bitwise"] = torch.equal(el.detach(), loss) and same
    train = per_step_counts(L, opt_kernels=0)
    train = {k: v for k, v in train.items() if v and k != "opt"}
    checks[f"(b) grad_and_loss launches K4a {L}, K4b {L} + {L}, K5a/K5b "
           f"{2 * L + 1}, K6 {2 * L} (q + k forward and backward), no other "
           "kernel"] = {k: v for k, v in step_counts.items() if v} == train
    model.zero_grad(set_to_none=True)
    del grads, el
    step_ms2 = sync_ms(torch, lambda: vg(params, (ids,)))[1]
    del params
    prefix = os.path.join(root, "llama", "model")
    _, save_ms = sync_ms(torch, lambda: pt.jit.save(
        model, prefix, input_spec=[InputSpec([-1, S], "int64")]))
    loaded, load_ms = sync_ms(torch, lambda: pt.jit.load(prefix))
    mb = os.path.getsize(prefix + ".pdmodel") / 2 ** 20
    arch = {}
    for b in (8, 4):
        zero_counts()
        out, ms = sync_ms(torch, lambda: loaded(ids[:b]))
        counts = read_counts()
        with torch.no_grad():
            ref = model(ids[:b])
        arch[b] = (torch.equal(out, ref), ms, counts)
        del out, ref
    checks["(b) the jit.save archive = eager at batch 8 and 4, bitwise"] = \
        all(v[0] for v in arch.values())
    checks["(b) the archive's launches K4a, K5a and K6 (custom ops) a "
           "layer"] = all({k: v for k, v in c.items() if v} == want
                          for _s, _m, c in arch.values())
    log(f"static_jit (b) [{card}]: LlamaForCausalLM(llama_350m()) bf16, "
        f"{B} x {S}; to_static {fwd_ms:.2f} / {fwd_ms2:.2f} ms a forward, "
        f"launches {fwd_counts and {k: v for k, v in fwd_counts.items() if v}}; "
        f"grad_and_loss {step_ms:.2f} / {step_ms2:.2f} ms a step, loss "
        f"{float(loss):.6f}, "
        f"launches {({k: v for k, v in step_counts.items() if v})}; "
        f"jit.save {save_ms / 1e3:.2f} s (archive {mb:.1f} MiB), jit.load "
        f"{load_ms / 1e3:.2f} s; the archive at batch 8 {arch[8][1]:.2f} ms,"
        f" 4 {arch[4][1]:.2f} ms; launches "
        f"{ {b: {k: v for k, v in c.items() if v} for b, (_e, _m, c) in arch.items()} }")
    return {"fwd_counts": fwd_counts, "step_counts": step_counts}


def static_jit_dy2static(torch, np, pt, card, root, checks):
    """(c): the reference's ``test_to_static_with_control_flow`` and
    ``test_layer_with_loop_under_jit`` with card tensors against the CPU,
    and a saved layer whose forward calls a ``to_static`` function with a
    tensor-dependent ``if``: its archive takes both branches."""
    from paddle_tpu_torch.jit.dy2static import convert_to_static
    from paddle_tpu_torch.static import InputSpec

    @pt.jit.to_static
    def relu_like(x):
        y = x
        if x.sum() > 0:
            y = y * 2
        else:
            y = y * 0
        return y

    def body(x, steps):
        acc = x * 0
        for i in range(steps):
            acc = acc + torch.sin(x + i)
        return acc

    same = []
    for v in ([1.0, 2.0], [-1.0, -2.0]):
        card_out = relu_like(pt.to_tensor(v, place="gpu")).value
        cpu_out = relu_like(pt.to_tensor(v, place="cpu")).value
        same.append(torch.equal(card_out.cpu(), cpu_out))
    static = convert_to_static(body)
    xs = torch.tensor([0.5])
    loop = {"card": static(xs.cuda(), torch.tensor(3, device="cuda")),
            "cpu": static(xs, torch.tensor(3))}
    same.append(torch.equal(loop["card"].cpu(), loop["cpu"]))

    class Loop(torch.nn.Module):
        def forward(self, x, n):
            return static(x, n)

    ep = torch.export.export(Loop(), (xs.cuda(), torch.tensor(3,
                                                           device="cuda")))
    got = ep.module()(xs.cuda(), torch.tensor(3, device="cuda"))
    same.append(torch.equal(got.cpu(), loop["cpu"]))
    checks["(c) dy2static on the card = the CPU (if, for; exported loop)"] = \
        all(same)

    class Gate(pt.nn.Layer):
        def forward(self, x):
            return relu_like(x)

    layer = Gate()
    prefix = os.path.join(root, "gate", "gate")
    pt.jit.save(layer, prefix, input_spec=[InputSpec([-1, 1024],
                                                     "float32")])
    loaded = pt.jit.load(prefix)
    conds = sum("cond" in str(n.target) for n in
                loaded.program.graph.nodes)
    branches = []
    for sign in (1.0, -1.0):
        x = sign * torch.rand((8, 1024), device="cuda")
        branches.append(torch.equal(loaded(x), layer(x)))
    checks["(c) the exported to_static layer takes both branches"] = \
        all(branches) and conds >= 1
    log(f"static_jit (c) [{card}]: card = CPU {same}; the archive's "
        f"torch.cond nodes {conds}, branches {branches}; torch "
        f"{torch.__version__}")


def phase_static_jit(torch, np, card, record):
    """Phase static_jit: (a) the static stack, (b) jit on llama_350m, (c)
    dy2static on the card; every gate checked after all three ran."""
    import shutil
    import tempfile
    import paddle_tpu_torch as pt
    root = tempfile.mkdtemp(prefix="chip_smoke_static_")
    checks = {}
    try:
        a = static_jit_stack(torch, np, pt, card, root, checks)
        torch.cuda.empty_cache()
        b = static_jit_llama(torch, np, pt, card, root, checks)
        torch.cuda.empty_cache()
        static_jit_dy2static(torch, np, pt, card, root, checks)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, good in checks.items():
        log(f"  static_jit {'ok' if good else 'FAIL'}: {name}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"static_jit: check failed: {name}")
    rc, ac = a["run_counts"], a["arch_counts"]
    record["flash_attention_fwd"]["static_jit_launches"] = {
        "static_run": rc["k4_fwd"], "archive": ac["k4_fwd"],
        "to_static": b["fwd_counts"]["k4_fwd"],
        "grad_and_loss": b["step_counts"]["k4_fwd"]}
    record["flash_attention_bwd"]["static_jit_launches"] = {
        "static_run": rc["k4_dq"], "grad_and_loss": b["step_counts"]["k4_dq"]}
    record["rms_norm_fwd"]["static_jit_launches"] = {
        "static_run": rc["k5_fwd"], "archive": ac["k5_fwd"],
        "to_static": b["fwd_counts"]["k5_fwd"],
        "grad_and_loss": b["step_counts"]["k5_fwd"]}
    record["rms_norm_bwd"]["static_jit_launches"] = {
        "static_run": rc["k5_bwd"],
        "grad_and_loss": b["step_counts"]["k5_bwd"]}
    record["rope"]["static_jit_launches"] = {
        "to_static": b["fwd_counts"]["k6_qk"],
        "grad_and_loss": b["step_counts"]["k6_qk"]}


# ------------------------------------------------------ quantization, incubate

# the sizes of the quant phases (a CPU rehearsal shrinks them)
QUANT = {"B": 8, "S": 1024, "steps": 10, "infer_B": 8, "infer_S": 512,
         "calib_B": 2, "calib_S": 512, "calib_batches": 4, "chunk": 1024,
         "mt_layers": 24, "mt_d": 1024, "mt_heads": 16, "mt_ffn": 4096,
         "mt_B": 8, "mt_S": 512, "mt_T": 544, "mt_decode": 32}
# the 5% logit rule of tests/test_generation.py: max |int8 - ref| under
# 5% of max |ref logit|
INT8_LOGIT_RULE = 0.05
# card against CPU at llama_tiny widths in f32 (TF32 off): QAT losses and
# moving scales (a rounding flip of one activation code moves a loss by
# far less), fused_multi_transformer and fused CE values
QUANT_PARITY_TOL = {"loss": 1e-4, "scale": 1e-4, "mt": 1e-4, "ce": 1e-5}
# bf16 at full width: fused CE's loss against model.loss's (the same bf16
# logits, summed in another order) and lm_head's gradient (chunk partials
# summed in bf16), relative to the plain step's largest
FUSED_CE_TOL = {"loss": 1e-4, "grad": 2e-2}
# the static cache's decode against the growing cache's, relative to the
# largest |output|: in f32 (TF32 off) the two differ by the masked
# composition against K4's f32 route, summation order only; in bf16 each
# of 24 layers rounds q, k, v, P (K4) or p (the composition) and the
# attention output to 8 bits (2^-8 = 3.9e-3 an op): over about a hundred
# roundings of random sign that is ~4e-2, so bf16 is held to 5e-2 and to
# the f32 run's outputs likewise
STATIC_CACHE_RTOL = {"f32": 1e-4, "bf16": 5e-2}


def quant_config(Q):
    """The issue's QAT config: moving abs-max activations (rate 0.9),
    channel-wise abs-max weights."""
    return Q.QuantConfig(
        activation=Q.FakeQuanterWithAbsMaxObserver(moving_rate=0.9),
        weight=Q.FakeQuanterChannelWiseAbsMax())


def mt_weights(torch, L, d, ffn, dtype, device, seed=0):
    """``fused_multi_transformer``'s weight lists, pre-LN, from a seeded
    generator on the CPU (the same values on any device): LN scales
    1 + N(0, 0.02), biases N(0, 0.02), projections N(0, 0.02); the qkv
    weight ``[3 d, d]`` (``trans_qkvw=True``)."""
    g = torch.Generator().manual_seed(seed)

    def mk(*s, one=False):
        t = torch.randn(*s, generator=g) * 0.02 + (1.0 if one else 0.0)
        return t.to(device=device, dtype=dtype)

    return dict(
        ln_scales=[mk(d, one=True) for _ in range(L)],
        ln_biases=[mk(d) for _ in range(L)],
        qkv_weights=[mk(3 * d, d) for _ in range(L)],
        qkv_biases=[mk(3 * d) for _ in range(L)],
        linear_weights=[mk(d, d) for _ in range(L)],
        linear_biases=[mk(d) for _ in range(L)],
        ffn_ln_scales=[mk(d, one=True) for _ in range(L)],
        ffn_ln_biases=[mk(d) for _ in range(L)],
        ffn1_weights=[mk(d, ffn) for _ in range(L)],
        ffn1_biases=[mk(ffn) for _ in range(L)],
        ffn2_weights=[mk(ffn, d) for _ in range(L)],
        ffn2_biases=[mk(d) for _ in range(L)])


def mt_decode_run(torch, f, w, heads, x, steps, T, static):
    """A prefill of ``x`` then one decode step per entry of ``steps``,
    through a static ``[2, B, H, T, hd]`` cache (``time_step``) or a
    growing one: (prefill output, decode outputs, ms a prefill, ms a
    decode step)."""
    B, S, d = x.shape
    shape = (2, B, heads, T if static else 0, d // heads)
    caches = [torch.zeros(shape, dtype=x.dtype, device=x.device)
              for _ in w["qkv_weights"]]
    kw = {"time_step": 0} if static else {}
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out, caches = f(x, cache_kvs=caches, num_heads=heads, **kw, **w)
    sync()
    t1 = time.perf_counter()
    outs = []
    for i, s in enumerate(steps):
        kw = {"time_step": S + i} if static else {}
        o, caches = f(s, cache_kvs=caches, num_heads=heads, **kw, **w)
        outs.append(o)
    sync()
    t2 = time.perf_counter()
    if static:
        assert all(c.shape[3] == T for c in caches)
    return out, outs, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(len(steps), 1)


def rel_err(torch, got, want):
    """max |got - want| over max |want|, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_quant_parity(torch, np):
    """The quant phase's three paths at llama_tiny / tiny widths in f32,
    on the card and on the CPU from the same weights and batches."""
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_multi_transformer
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_buffers,
                                         export_params, llama_tiny,
                                         load_jax_params)
    from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_tiny()
    L = cfg.num_layers
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=9)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    ids = np.random.default_rng(9).integers(0, cfg.vocab_size, (4, 64))
    tol = QUANT_PARITY_TOL
    res = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = torch.as_tensor(ids, device=model.device)
        qat = Q.QAT(quant_config(Q))
        qm = qat.quantize(model)
        opt = AdamW(learning_rate=1e-3, parameters=qm.named_parameters())
        step = train_step_fn(qm, qm.loss, opt)
        zero_counts()
        losses = [step({"inputs": (t,), "labels": (t,)}).item()
                  for _ in range(3)]
        counts = read_counts()
        scales = {n: m._scale.item() for n, m in qm.named_modules()
                  if isinstance(m, Q.FakeQuanterWithAbsMaxObserverLayer)}
        res[name] = (losses, scales, qat.convert(qm), counts, t)
    (l_c, s_c, conv_c, _, t_c), (l_g, s_g, conv_g, c_g, t_g) = \
        res["cpu"], res["cuda"]
    loss_err = max(abs(a - b) for a, b in zip(l_c, l_g))
    scale_err = max(abs(s_g[n] - s_c[n]) / max(abs(s_c[n]), 1.0)
                    for n in s_c)
    want = per_step_counts(L, 3)
    # the int8 codes of the same weights: the CPU's trained ones and
    # observer scales in both
    load_jax_params(conv_g, export_params(conv_c),
                    buffers=export_buffers(conv_c))
    i8c = Q.to_int8_inference(conv_c, inplace=True)
    i8g = Q.to_int8_inference(conv_g, inplace=True)
    cb = dict(i8c.named_buffers())
    held = {n: b for n, b in i8g.named_buffers()
            if n.endswith(("qweight_t", "w_scale"))}
    codes = len(held) == 2 * (7 * L + 1) and all(
        torch.equal(b.cpu(), cb[n]) for n, b in held.items())
    zero_counts()
    with torch.no_grad():
        lg = i8g(t_g)
        k8 = read_counts()["k8"]
        lc = i8c(t_c)
    i8_err = (lg.cpu() - lc).abs().max().item()
    i8_scale = lc.abs().max().item()
    # fused_multi_transformer: prefill without a cache, then static and
    # growing caches, card against CPU
    heads, d = 4, 64
    w_c = mt_weights(torch, 2, d, 4 * d, torch.float32, "cpu", seed=3)
    w_g = {k: [a.cuda() for a in v] for k, v in w_c.items()}
    gx = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, d, generator=gx)
    steps = [torch.randn(2, 1, d, generator=gx) for _ in range(4)]
    zero_counts()
    p_g = fused_multi_transformer(x.cuda(), num_heads=heads, **w_g)
    torch.cuda.synchronize()
    k4_prefill = read_counts()["k4_fwd"]
    p_c = fused_multi_transformer(x, num_heads=heads, **w_c)
    mt_err = (p_g.cpu() - p_c).abs().max().item()
    for static in (True, False):
        og, dg, _, _ = mt_decode_run(torch, fused_multi_transformer, w_g,
                                     heads, x.cuda(),
                                     [s.cuda() for s in steps], 24, static)
        oc, dc, _, _ = mt_decode_run(torch, fused_multi_transformer, w_c,
                                     heads, x, steps, 24, static)
        mt_err = max([mt_err, (og.cpu() - oc).abs().max().item()]
                     + [(a.cpu() - b).abs().max().item()
                        for a, b in zip(dg, dc)])
    # fused CE on the tiny model's hidden states
    ce = []
    for model, t in ((cpu, t_c), (gpu, t_g)):
        with torch.no_grad():
            h = model(t, return_hidden=True)
        ce.append(fused_linear_cross_entropy(
            h[:, :-1], model.lm_head.weight, t[:, 1:], chunk_size=100).item())
    ce_err = abs(ce[0] - ce[1])
    log(f"quant_parity llama_tiny f32: QAT losses cpu "
        f"{[round(x, 6) for x in l_c]} card {[round(x, 6) for x in l_g]} "
        f"(max diff {loss_err:.2e}, tol {tol['loss']}), {len(s_c)} moving "
        f"scales max rel diff {scale_err:.2e} (tol {tol['scale']}); launches "
        f"over 3 QAT steps {c_g}; int8 codes and scales of the CPU-trained "
        f"weights equal card/CPU {codes}, K8 {k8} a forward, logits max diff "
        f"{i8_err:.3e} (tol 1e-3 of max |logit| {i8_scale:.3e}); "
        f"fused_multi_transformer (2 layers, d 64, 4 heads) prefill, static "
        f"and growing caches max diff {mt_err:.2e} (tol {tol['mt']}), K4a "
        f"{k4_prefill} a prefill; fused CE {ce[1]:.6f} card, {ce[0]:.6f} "
        f"CPU (tol {tol['ce']})")
    checks = {
        "QAT losses card = CPU": loss_err <= tol["loss"],
        "QAT losses fall": l_g[-1] < l_g[0],
        "moving scales card = CPU": scale_err <= tol["scale"]
        and s_c.keys() == s_g.keys() and len(s_c) == 7 * L + 1,
        "QAT launches == 3 train steps":
            {k: c_g[k] for k in want} == want,
        "int8 codes and scales equal": codes,
        "K8 7 x layers + 1": k8 == 7 * L + 1,
        "int8 logits card = CPU": i8_err <= 1e-3 * i8_scale,
        "fused_multi_transformer card = CPU": mt_err <= tol["mt"],
        "K4a once a layer without a cache": k4_prefill == 2,
        "fused CE card = CPU": ce_err <= tol["ce"]}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"quant_parity: check failed: {name}")


def qat_steps(torch, np, model, ids, n):
    """QAT of ``model`` in place with the issue's config, then 2 warm-up
    steps and ``n`` timed ``train_step_fn`` + ``AdamW(1e-4)`` steps on
    ``ids``, the counters zeroed just before the timed steps and read
    just after."""
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.optimizer import AdamW
    qat = Q.QAT(quant_config(Q))
    qm = qat.quantize(model, inplace=True)
    swapped = sum(isinstance(m, Q.QuantedLinear) for m in qm.modules())
    opt = AdamW(learning_rate=1e-4, parameters=qm.named_parameters())
    step = train_step_fn(qm, qm.loss, opt)
    batch = {"inputs": (ids,), "labels": (ids,)}
    losses = [step(batch) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"qat": qat, "model": qm, "swapped": swapped, "step": step,
            "losses": [x.item() for x in losses], "counts": read_counts(),
            "step_ms": wall / n * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "logits_dtype": qm(ids[:1, :8]).dtype}


def fused_ce_check(torch, np, model, ids, chunk):
    """``model.loss`` against ``fused_linear_cross_entropy`` of the
    hidden states and ``lm_head.weight``, forward and backward from zero
    gradients, each step's peak memory and ms."""
    from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    def plain():
        return model.loss(model(ids), ids)

    def fused():
        h = model(ids, return_hidden=True)
        return fused_linear_cross_entropy(h[:, :-1], model.lm_head.weight,
                                          ids[:, 1:], chunk_size=chunk)

    out = {}
    for name, fn in (("plain", plain), ("fused", fused), ("plain", plain),
                     ("fused", fused)):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = fn()
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = (loss.item(), model.lm_head.weight.grad.clone(),
                     torch.cuda.max_memory_allocated() / 2 ** 30, ms)
    model.zero_grad(set_to_none=True)
    return out


def phase_quant(torch, np, card, record, train):
    """llama_350m in bf16 from seed 0: fused CE against the plain loss
    step, PTQ calibration, QAT steps, convert and the int8 deployment;
    then ``fused_multi_transformer`` at GPT-2 345M's widths, and the
    fused encoder layer's dropouts."""
    import gc
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_multi_transformer
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    gc.collect()
    torch.cuda.empty_cache()
    q = QUANT
    cfg = llama_350m()
    L = cfg.num_layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (q["B"], q["S"])),
                          device="cuda")
    # (b) fused CE against the plain loss step
    ce = fused_ce_check(torch, np, model, ids, q["chunk"])
    (lp, gp, peak_p, ms_p), (lf, gf, peak_f, ms_f) = ce["plain"], ce["fused"]
    loss_rel = abs(lf - lp) / abs(lp)
    grad_rel = rel_err(torch, gf, gp)
    log(f"quant fused CE [{card}]: llama_350m bf16 {q['B']} x {q['S']}, "
        f"chunk {q['chunk']}: loss fused {lf:.6f} plain {lp:.6f} (rel diff "
        f"{loss_rel:.2e}, tol {FUSED_CE_TOL['loss']}), lm_head gradient max "
        f"diff {grad_rel:.2e} of its largest (tol {FUSED_CE_TOL['grad']}); "
        f"peak memory fused {peak_f:.2f} GiB, plain {peak_p:.2f} GiB; a "
        f"forward + backward fused {ms_f:.1f} ms, plain {ms_p:.1f} ms")
    # PTQ calibration with AbsmaxObserver on the activations
    ptq = Q.PTQ(Q.QuantConfig(activation=Q.AbsmaxObserver()))
    pm = ptq.quantize(model)
    calib = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (q["calib_B"], q["calib_S"])),
                            device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(q["calib_batches"]):
            pm(calib)
    calib_s = time.perf_counter() - t0
    observers = [m for m in ptq.convert(pm, inplace=True).modules()
                 if isinstance(m, Q.AbsmaxObserverLayer)]
    calibrated = len(observers) == 7 * L + 1 and all(
        m._frozen and m._max > 0 for m in observers)
    log(f"quant PTQ [{card}]: {len(observers)} AbsmaxObservers, "
        f"{q['calib_batches']} batches of {q['calib_B']} x {q['calib_S']} in "
        f"{calib_s:.2f} s (one host read an observer a batch), scales "
        f"{min(m._max for m in observers):.3f}.."
        f"{max(m._max for m in observers):.3f}")
    del pm, observers
    # (a) QAT steps, then convert and the int8 deployment
    r = qat_steps(torch, np, model, ids, q["steps"])
    losses, counts = r["losses"], r["counts"]
    want = per_step_counts(L, q["steps"])
    train_ms = train["step_ms"] if train else None
    log(f"quant QAT losses: {[round(x, 4) for x in losses]}")
    log(f"quant QAT [{card}]: {r['swapped']} QuantedLinear, logits "
        f"{str(r['logits_dtype']).replace('torch.', '')}; "
        f"{r['step_ms']:.1f} ms per step (the train phase's bf16 step "
        f"{'%.1f ms' % train_ms if train_ms else 'not run'}), "
        f"{q['B'] * q['S'] / r['step_ms'] * 1e3:.0f} tokens/s, peak memory "
        f"{r['peak_gb']:.2f} GiB; launches over {q['steps']} steps {counts}")
    qm, qat, swapped = r["model"], r["qat"], r["swapped"]
    logits_f32 = r["logits_dtype"] == torch.float32
    profile_once(torch, lambda: r["step"]({"inputs": (ids,),
                                           "labels": (ids,)}),
                 card, "qat_step")
    conv = qat.convert(qm)
    del r, qm, model
    gc.collect()
    torch.cuda.empty_cache()
    infer = ids[:q["infer_B"], :q["infer_S"]].contiguous()
    with torch.no_grad():
        ref = conv(infer)
        i8 = Q.to_int8_inference(conv, inplace=True)
        i8(infer)                                   # warm
        zero_counts()
        out = i8(infer)
        torch.cuda.synchronize()
        c_i8 = read_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            i8(infer)
        torch.cuda.synchronize()
        ms_i8 = (time.perf_counter() - t0) / 3 * 1e3
        profile_once(torch, lambda: i8(infer), card, "qat_int8_infer",
                     "forward")
    i8_rel = rel_err(torch, out, ref)
    log(f"quant int8 [{card}]: to_int8_inference of the converted QAT model, "
        f"{q['infer_B']} x {q['infer_S']}: K8 {c_i8['k8']} a forward, "
        f"{ms_i8:.1f} ms a forward; logits max |int8 - QAT eval| "
        f"{i8_rel:.4f} of max |QAT eval logit| (rule {INT8_LOGIT_RULE})")
    del i8, conv, ref, out
    gc.collect()
    torch.cuda.empty_cache()
    # (c) fused_multi_transformer at GPT-2 345M's widths
    Lm, d, heads = q["mt_layers"], q["mt_d"], q["mt_heads"]
    w = mt_weights(torch, Lm, d, q["mt_ffn"], torch.bfloat16, "cuda")
    gx = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(q["mt_B"], q["mt_S"], d, generator=gx, device="cuda",
                    dtype=torch.bfloat16)
    steps = [torch.randn(q["mt_B"], 1, d, generator=gx, device="cuda",
                         dtype=torch.bfloat16)
             for _ in range(q["mt_decode"])]
    w32 = {k: [a.float() for a in v] for k, v in w.items()}
    with torch.no_grad():
        fused_multi_transformer(x, num_heads=heads, **w)       # warm
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nocache = fused_multi_transformer(x, num_heads=heads, **w)
        torch.cuda.synchronize()
        ms_nocache = (time.perf_counter() - t0) * 1e3
        c_mt = read_counts()
        runs = {}
        for static in (True, False, True, False):
            runs[static] = mt_decode_run(torch, fused_multi_transformer, w,
                                         heads, x, steps, q["mt_T"], static)
        runs32 = {static: mt_decode_run(
            torch, fused_multi_transformer, w32, heads, x.float(),
            [s.float() for s in steps], q["mt_T"], static)
            for static in (True, False)}
    (ps, ds, ms_ps, ms_ds), (pg, dg, ms_pg, ms_dg) = runs[True], runs[False]
    (ps32, ds32, _, _), (pg32, dg32, _, _) = runs32[True], runs32[False]

    def worst(a, b):
        return max(rel_err(torch, u, v) for u, v in zip(a, b))

    dec_rel = worst(ds, dg)
    pre_rel = rel_err(torch, ps, pg)
    dec32_rel = max(worst(ds32, dg32), rel_err(torch, ps32, pg32))
    to32 = max(worst(ds, dg32), worst(dg, dg32))
    finite = all(torch.isfinite(t).all().item()
                 for t in [nocache, ps, pg] + ds + dg)
    log(f"quant fused_multi_transformer [{card}]: GPT-2 345M widths "
        f"({Lm} layers, d {d}, {heads} heads, FFN {q['mt_ffn']}, gelu, "
        f"pre-LN) bf16, {q['mt_B']} x {q['mt_S']}: without a cache "
        f"{ms_nocache:.1f} ms, K4a {c_mt['k4_fwd']}; static cache [2, "
        f"{q['mt_B']}, {heads}, {q['mt_T']}, {d // heads}] prefill "
        f"{ms_ps:.1f} ms, {ms_ds:.2f} ms a decode step; growing cache "
        f"prefill {ms_pg:.1f} ms, {ms_dg:.2f} ms a decode step; "
        f"{q['mt_decode']} decode steps static vs growing max diff "
        f"{dec_rel:.2e} of the largest |output|, prefill {pre_rel:.2e}, "
        f"each bf16 path against the f32 growing run {to32:.2e} (tol "
        f"{STATIC_CACHE_RTOL['bf16']}); in f32 static vs growing "
        f"{dec32_rel:.2e} (tol {STATIC_CACHE_RTOL['f32']})")
    # the fused encoder layer's dropouts on R2
    layer = FusedTransformerEncoderLayer(d, heads, q["mt_ffn"],
                                         dropout_rate=0.1).to(torch.bfloat16)
    layer.train()
    xe = x.detach().clone().requires_grad_()
    zero_counts()
    layer(xe).float().square().mean().backward()
    torch.cuda.synchronize()
    c_enc = read_counts()
    log(f"quant FusedTransformerEncoderLayer [{card}]: bf16 {q['mt_B']} x "
        f"{q['mt_S']}, dropout 0.1, one training forward + backward: R2 "
        f"dropout {c_enc['r2_dropout']} (4 forwards, 4 backwards), K4 "
        f"{c_enc['k4_fwd']} (attention dropout takes the composition)")
    checks = {
        "fused CE loss": loss_rel <= FUSED_CE_TOL["loss"],
        "fused CE lm_head gradient": grad_rel <= FUSED_CE_TOL["grad"],
        "fused CE peak below the plain loss step's": peak_f < peak_p,
        "PTQ: every observer calibrated and frozen": calibrated,
        "QAT swaps 7 x layers + 1 Linears": swapped == 7 * L + 1,
        "QAT logits f32 (the reference's promotion)": logits_f32,
        "QAT losses finite and falling": all(np.isfinite(losses))
        and losses[-1] < losses[0],
        "QAT launches == steps x the train step's kernels":
            {k: counts[k] for k in want} == want,
        "int8 forward: K8 7 x layers + 1": c_i8["k8"] == 7 * L + 1,
        "int8 logits within the 5% rule": i8_rel < INT8_LOGIT_RULE,
        "fused_multi_transformer: K4a once a layer without a cache":
            c_mt["k4_fwd"] == Lm,
        "static cache = growing cache in f32":
            dec32_rel <= STATIC_CACHE_RTOL["f32"],
        "static cache = growing cache in bf16, both near f32":
            max(dec_rel, pre_rel, to32) <= STATIC_CACHE_RTOL["bf16"],
        "fused_multi_transformer outputs finite": finite,
        "the encoder layer's dropouts on R2": c_enc["r2_dropout"] == 8}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"quant: check failed: {name}")
    record["quant_matmul"]["quant_launches"] = {
        "qat_int8_forward": c_i8["k8"]}
    record["flash_attention_fwd"]["quant_launches"] = {
        "qat_steps": counts["k4_fwd"],
        "fused_multi_transformer_prefill": c_mt["k4_fwd"]}
    record["flash_attention_bwd"]["quant_launches"] = {
        "qat_steps": counts["k4_dq"]}
    record["rms_norm_fwd"]["quant_launches"] = {"qat_steps": counts["k5_fwd"]}
    record["rms_norm_bwd"]["quant_launches"] = {"qat_steps": counts["k5_bwd"]}
    record["rope"]["quant_launches"] = {"qat_steps": counts["k6_qk"]}
    record["multi_tensor_adam"]["quant_launches"] = {
        "qat_steps": counts["opt"]}
    record["threefry_fill"]["quant_launches"] = {
        "fused_encoder_layer_step": c_enc["r2_dropout"]}


# ------------------------------------------------------------------ moe

# mixtral_tiny f32, card against CPU: the logits and every gradient
# within 1e-5 and 1e-4 of their largest |value| (another summation order
# in cuBLAS and the kernels), the aux loss within 1e-6, the train steps'
# losses within 1e-5. A routing decision may differ only where the CPU's
# top-2 (or 2nd and 3rd) gate probabilities lie within MOE_TIE; the
# logits and dispatch masks are then held at the tokens no flip reaches,
# and the aux loss, gradients and losses, which every token reaches, fail.
MOE_PARITY_TOL = {"logits": 1e-5, "aux": 1e-6, "grad": 1e-4, "loss": 1e-5}
MOE_TIE = 1e-5
# the moe phase: moe_350m_8e(moe_group_size=1024) at batch 8 x 1024
MOE = {"B": 8, "S": 1024, "steps": 10, "warmup": 2, "group": 1024,
       "workers": 2, "lr": 1e-4, "clip": 1.0}


class TokenRows:
    """A map-style dataset of seeded token rows (int64 ``[S]`` each); a
    module-level class, so forked loader workers share it."""

    def __init__(self, ids):
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i]


def moe_gate_probe(model):
    """Forward post-hooks on every block's gate; each call appends the
    layer's gate probabilities (f32 ``[..., T, E]``) and dispatch mask, as
    numpy arrays, to the returned list. Returns (records, handles)."""
    import torch
    seen = []

    def hook(layer, inputs, out):
        with torch.no_grad():
            probs = torch.softmax((inputs[0] @ layer.gate.weight).float(),
                                  dim=-1)
        seen.append((probs.cpu().numpy(),
                     out.dispatch_mask.cpu().numpy()))

    return seen, [blk.moe.gate.register_forward_post_hook(hook)
                  for blk in model.model.layers]


def moe_routes(np, probs, k=2):
    """Each token's top-k experts (the first maximum first, as argmax)."""
    return np.argsort(-probs, axis=-1, kind="stable")[..., :k]


def moe_parity_run(torch, np, model, ids, steps=3, lr=1e-3):
    """One Mixtral model's side of moe_parity: the forward's logits, aux
    loss, loss and each block's gate probabilities and dispatch mask, the
    gradients of ``loss.backward()``, then ``steps`` AdamW steps through
    ``jit.train_step_fn`` (their losses). Numpy out, f32."""
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.optimizer import AdamW
    t = torch.as_tensor(ids, device=model.device)
    seen, hooks = moe_gate_probe(model)
    try:
        logits = model(t)
        loss = model.loss(logits, t)
    finally:
        for h in hooks:
            h.remove()
    loss.backward()
    out = {"logits": logits.detach().float().cpu().numpy(),
           "aux": model.collect_aux_loss().item(), "loss": loss.item(),
           "probs": [p for p, _ in seen], "masks": [m for _, m in seen],
           "grads": {n: p.grad.float().cpu().numpy()
                     for n, p in model.named_parameters()}}
    for p in model.parameters():
        p.grad = None
    opt = AdamW(learning_rate=lr, parameters=model.named_parameters())
    step = train_step_fn(model, model.loss, opt)
    batch = {"inputs": (t,), "labels": (t,)}
    out["losses"] = [step(batch).item() for _ in range(steps)]
    return out


def moe_reach(np, hit, S, group):
    """The tokens (flat, in the batch's order) that a change at the tokens
    ``hit`` reaches, in its block and the later ones: each one's later
    tokens in its row of ``S`` (causal attention) and in its dispatch
    group of ``group`` (the capacity positions run in token order)."""
    idx = np.arange(hit.size)
    out = hit.copy()
    for unit in (S, group):
        first = np.where(hit, idx, hit.size).reshape(-1, unit).min(
            -1, keepdims=True)
        out |= (idx.reshape(-1, unit) >= first).reshape(-1)
    return out


def moe_parity_compare(np, got, want, tol=MOE_PARITY_TOL, tie=MOE_TIE):
    """``got`` against the yardstick ``want`` (two ``moe_parity_run``
    results): (checks, numbers). Block by block, the top-2 routing of the
    tokens no earlier flip reaches equal but at near-ties of ``want``'s
    probabilities, and the dispatch masks equal at the tokens no flip
    reaches (``moe_reach``); the logits within ``tol`` at those tokens
    (there must be some); the aux loss, the gradients and the losses
    within ``tol``, which needs equal routing everywhere."""
    B, S = want["logits"].shape[:2]
    N = B * S
    reached = np.zeros(N, bool)
    flips = near = 0
    masks_equal = True
    for pg, pw, mg, mw in zip(got["probs"], want["probs"], got["masks"],
                              want["masks"]):
        E = pw.shape[-1]
        group = pw.shape[-2] if pw.ndim == 3 else N
        pg, pw = pg.reshape(N, E), pw.reshape(N, E)
        differ = (moe_routes(np, pg) != moe_routes(np, pw)).any(-1) \
            & ~reached
        srt = -np.sort(-pw, axis=-1)
        gaps = np.minimum(srt[..., 0] - srt[..., 1], srt[..., 1] - srt[..., 2])
        flips += int(differ.sum())
        near += int((differ & (gaps <= tie)).sum())
        reached = moe_reach(np, reached | differ, S, group)
        masks_equal &= bool(np.array_equal(mg.reshape(N, -1)[~reached],
                                           mw.reshape(N, -1)[~reached]))

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    kept = int((~reached).sum())
    nums = {"routing flips": flips, "near-tie flips": near,
            "tokens no flip reaches": kept,
            "logits": rel(got["logits"].reshape(N, -1)[~reached],
                          want["logits"].reshape(N, -1)[~reached])
            if kept else float("inf"),
            "aux": abs(got["aux"] - want["aux"]),
            "grad": max(rel(got["grads"][n], want["grads"][n])
                        for n in want["grads"]),
            "loss": max(abs(a - b) for a, b in
                        zip(got["losses"], want["losses"]))}
    equal = flips == 0
    checks = {
        "routing equal but at near-ties": flips == near,
        "dispatch masks equal where no flip reaches": masks_equal,
        "same parameters": set(got["grads"]) == set(want["grads"]),
        f"logits within {tol['logits']} of the largest where no flip "
        f"reaches": nums["logits"] <= tol["logits"],
        f"aux loss within {tol['aux']} (needs equal routing)":
            equal and nums["aux"] <= tol["aux"],
        f"gradients within {tol['grad']} of their largest (needs equal "
        f"routing)": equal and nums["grad"] <= tol["grad"],
        f"3 AdamW steps' losses within {tol['loss']} (needs equal "
        f"routing)": equal and nums["loss"] <= tol["loss"]}
    return checks, nums


def phase_moe_parity(torch, np):
    from paddle_tpu_torch.models import (MixtralForCausalLM, export_params,
                                         load_jax_params, mixtral_tiny)
    cfg = mixtral_tiny()
    cpu = MixtralForCausalLM(cfg, device="cpu", seed=5)
    gpu = MixtralForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    # 2 x 128 tokens: two dispatch groups of max_seq_len (128)
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 128))
    want = moe_parity_run(torch, np, cpu, ids)
    zero_counts()
    got = moe_parity_run(torch, np, gpu, ids)
    counts = read_counts()
    checks, nums = moe_parity_compare(np, got, want)
    L = cfg.num_layers
    # the forward and backward by hand, then 3 train steps
    fused = per_step_counts(L, 4)
    fused.update(opt=3, opt_kernels=3)
    checks["launches: 4 forwards and backwards, 3 fused steps"] = \
        {k: counts[k] for k in fused} == fused and \
        not any(counts[k] for k in ("k1", "k2", "k3", "k7", "k8"))
    log(f"moe_parity mixtral_tiny f32, card against the CPU: {nums}; "
        f"losses cpu {[round(x, 6) for x in want['losses']]} card "
        f"{[round(x, 6) for x in got['losses']]}; launches {counts}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"moe_parity: check failed: {name}")


def moe_einsum_ms(torch, cfg, B, S, group, flush):
    """One step's dense dispatch and gather products (forward and
    backward, every layer) timed apart at the moe phase's shapes, bf16:
    (ms, TFLOP) of ``gtec,gtd->gecd`` and ``gtec,gecd->gtd`` with their
    gradients, from random routing weights."""
    E, D, L = cfg.num_experts, cfg.hidden_size, cfg.num_layers
    G, C = B * S // group, max(4, math.ceil(group * cfg.top_k
                                            * cfg.capacity_factor / E))
    gen = torch.Generator(device="cuda").manual_seed(0)
    comb = torch.rand((G, group, E, C), device="cuda", generator=gen) \
        .lt_(cfg.top_k / (E * C)).to(torch.bfloat16)
    x = torch.randn((G, group, D), device="cuda", dtype=torch.bfloat16,
                    generator=gen, requires_grad=True)
    ob = torch.randn((G, E, C, D), device="cuda", dtype=torch.bfloat16,
                     generator=gen, requires_grad=True)

    def run():
        b = torch.einsum("gtec,gtd->gecd", comb, x)
        o = torch.einsum("gtec,gecd->gtd", comb, ob)
        torch.autograd.backward((b, o), (torch.ones_like(b),
                                         torch.ones_like(o)))

    ms = cuda_ms(run, torch, flush=flush) * L
    flops = L * 3 * 2 * (2 * G * group * E * C * D)
    return ms, flops / 1e12


def phase_moe(torch, np, card, peak, record):
    """This slice's training path (docstring item 44)."""
    import gc
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import MixtralForCausalLM, moe_350m_8e
    from paddle_tpu_torch.ops.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.moe import ClipGradForMOEByGlobalNorm
    from paddle_tpu_torch.profiler import Profiler, RecordEvent
    gc.collect()
    torch.cuda.empty_cache()
    B, S, n, warm = MOE["B"], MOE["S"], MOE["steps"], MOE["warmup"]
    cfg = moe_350m_8e(moe_group_size=MOE["group"])
    L, E = cfg.num_layers, cfg.num_experts
    C = max(4, math.ceil(MOE["group"] * cfg.top_k * cfg.capacity_factor / E))
    model = MixtralForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                               seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    expert = sum(p.numel() for name, p in model.named_parameters()
                 if ".experts." in name)
    active = n_params - expert + expert * cfg.top_k // E
    log(f"moe: moe_350m_8e(moe_group_size={MOE['group']}) bf16 from seed 0, "
        f"{L} layers, {n_params} parameters ({expert} in the experts; "
        f"{active} active a token), "
        f"batch {B} x {S}, AdamW({MOE['lr']}) + ClipGradForMOEByGlobalNorm("
        f"{MOE['clip']}); reckoned: parameters {2 * n_params / 1e9:.2f} GB "
        f"bf16, moments {8 * n_params / 1e9:.2f} GB f32, combine f32 "
        f"[{B * S // MOE['group']}, {MOE['group']}, {E}, {C}] "
        f"{4 * B * S * E * C / 1e6:.0f} MB a layer")
    opt = AdamW(learning_rate=MOE["lr"], parameters=model.named_parameters(),
                grad_clip=ClipGradForMOEByGlobalNorm(MOE["clip"]))
    step = train_step_fn(model, model.loss, opt)
    # the train phase's regime (bench.py's): one fixed batch of 8 rows
    # from seed 0, which the dataset repeats for every step
    rows = np.tile(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), (n + warm + 1, 1))
    queue = [b.copy() for b in DataLoader(TokenRows(rows), batch_size=B,
                                          num_workers=MOE["workers"])]
    ring = DataLoader(TokenRows(rows), batch_size=B,
                      num_workers=MOE["workers"], use_native_ring=True)
    it = iter(ring)
    same = []

    def next_batch(i):
        b = next(it)
        same.append(np.array_equal(b, queue[i]))
        t = torch.as_tensor(b, device="cuda")
        return {"inputs": (t,), "labels": (t,)}

    losses, grads_finite = [], True
    try:
        for i in range(warm):
            batch = next_batch(i)
            ids = batch["inputs"][0]
            loss = model.loss(model(ids), ids)
            loss.backward()
            grads_finite &= all(torch.isfinite(p.grad).all().item()
                                for p in model.parameters())
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batches = [next_batch(warm + i) for i in range(n)]
        zero_counts()
        vector = rk.rope_qk_fwd.route_launches["vector"]
        t0 = time.perf_counter()
        for batch in batches:
            losses.append(step(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        counts["k6_qk_vector"] = rk.rope_qk_fwd.route_launches["vector"] \
            - vector
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # one more step under the port's profiler, inside a RecordEvent
        batch = next_batch(warm + n)
        prof = Profiler()
        with prof:
            t1 = time.perf_counter()
            with RecordEvent("moe_train_step"):
                step(batch)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t1) * 1e3
    finally:
        ring._shutdown_workers()
    losses = [x.item() for x in losses]
    step_ms = wall / n * 1e3
    n_tensors = len(list(model.parameters()))
    want = per_step_counts(L, n, opt_kernels=mta.kernels_per_step(n_tensors,
                                                                   True))
    trace, kernels = moe_trace_names(prof.export())
    busy = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    ein_ms, ein_tflop = moe_einsum_ms(torch, cfg, B, S, MOE["group"],
                                      torch.empty(64 << 20,
                                                  dtype=torch.int32,
                                                  device="cuda"))
    log(f"moe losses: {[round(x, 4) for x in losses]}")
    # the train phase's model FLOPs: 6 x the active parameters a token,
    # and the causal attention's products
    flops = 6 * active * B * S + 3 * 2 * B * cfg.num_heads * S * S \
        * cfg.head_dim * L
    log(f"moe metrics [{card}]: {step_ms:.1f} ms per step, "
        f"{B * S * n / wall:.0f} tokens/s, {flops / wall * n / 1e12:.1f} "
        f"model TFLOP/s ({100 * flops / wall * n / peak[1]:.1f}% of the "
        f"bf16 peak), peak memory {peak_gb:.2f} GiB; "
        f"the traced step's kernels {busy:.1f} ms: device busy "
        f"{100 * busy / step_ms:.1f}% of an untraced step, "
        f"{100 * busy / traced_ms:.1f}% of the traced step's "
        f"{traced_ms:.1f} ms wall (the profiler lengthens it); the "
        f"dispatch and gather products {ein_ms:.2f} ms a step "
        f"({ein_tflop:.2f} TFLOP, "
        f"timed apart; {100 * ein_ms / step_ms:.1f}% of the step)")
    log(f"moe launches over {n} steps: {counts}; want {want}")
    log(f"moe trace: {trace}; {sum(n for n, _ in kernels.values())} "
        f"kernel launches in the traced step, the most time in: " + ", ".join(
            f"{name[:60]} {ms:.3f} ms ({n}x)" for name, (n, ms) in top))
    checks = {
        "the ring's batches equal the queue transport's": all(same)
        and len(same) == n + warm + 1,
        "loss falls": losses[-1] < losses[0],
        "losses, weights and warm-up gradients finite":
            all(np.isfinite(losses)) and grads_finite and all(
                torch.isfinite(p).all().item() for p in model.parameters()),
        "launches == steps x per-step counts (K6: q + k, 2 x layers)":
            {k: counts[k] for k in want} == want,
        "K6 on the vector route": counts["k6_qk_vector"] == counts["k6_qk"],
        "no serving, epilogue or int8 kernel":
            not any(counts[k] for k in ("k1", "k2", "k3", "k7", "k8")),
        "the profiler's trace names K4, K5, K6, Opt and the RecordEvent":
            all(trace.values())}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"moe: check failed: {name}")
    record["flash_attention_fwd"]["moe_launches"] = counts["k4_fwd"]
    record["flash_attention_bwd"]["moe_launches"] = counts["k4_dq"]
    record["rms_norm_fwd"]["moe_launches"] = counts["k5_fwd"]
    record["rms_norm_bwd"]["moe_launches"] = counts["k5_bwd"]
    record["rope"]["moe_launches"] = counts["k6"] + counts["k6_qk"]
    record["multi_tensor_adam"]["moe_launches"] = counts["opt"]
    record["multi_tensor_adam"]["moe_kernel_launches"] = counts["opt_kernels"]
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()


MOE_TRACE = {"K4a": ("fwd_mma_kernel",), "K4b": ("dq_mma_kernel",
                                                 "dkv_mma_kernel"),
             "K5a": ("rms_fwd_kernel",), "K5b": ("rms_bwd_kernel",),
             "K6": ("rope_kernel",), "Opt": ("update_kernel",
                                              "sumsq_kernel")}


def trace_events(trace_dir):
    """The card's kernels in the Chrome traces of ``trace_dir``: {name:
    [launches, ms]} (durations summed); and the ``RecordEvent`` range
    names."""
    kernels, ranges = {}, set()
    for f in sorted(os.listdir(trace_dir)):
        with open(os.path.join(trace_dir, f)) as fh:
            for ev in json.load(fh).get("traceEvents", []):
                cat = ev.get("cat", "")
                if cat == "kernel":
                    k = kernels.setdefault(ev.get("name", ""), [0, 0.0])
                    k[0] += 1
                    k[1] += float(ev.get("dur", 0.0)) / 1e3
                elif cat == "user_annotation":
                    ranges.add(ev.get("name", ""))
    return kernels, ranges


def moe_trace_names(trace_dir):
    """Which of the port's kernels (``MOE_TRACE``) and whether the
    ``moe_train_step`` range appear in the Chrome traces of
    ``trace_dir``; and the card's kernels: {name: [launches, ms]}
    (durations summed)."""
    kernels, ranges = trace_events(trace_dir)
    out = {k: all(any(w in name for name in kernels) for w in want)
           for k, want in MOE_TRACE.items()}
    out["RecordEvent moe_train_step"] = "moe_train_step" in ranges
    return out, kernels


HOST_EXT = """
extern "C" void cube_fwd(const float* x, long long n, float* y) {
    for (long long i = 0; i < n; ++i) y[i] = x[i] * x[i] * x[i];
}
extern "C" void cube_bwd(const float* x, const float* gy, long long n,
                         float* gx) {
    for (long long i = 0; i < n; ++i) gx[i] = 3.0f * x[i] * x[i] * gy[i];
}
"""


def phase_host(torch, np, card):
    """The host-side framework on the card (docstring item 45)."""
    import io
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as pdev
    from paddle_tpu_torch import runtime
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.utils import cpp_extension, run_check
    checks = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8192, 1024), device="cuda", dtype=torch.bfloat16,
                    generator=gen)
    w = torch.rand((1024,), device="cuda", dtype=torch.bfloat16,
                   generator=gen) + 0.5
    ref = F.rms_norm(x, w)
    s1, s2 = pdev.cuda.Stream(), pdev.cuda.Stream()
    e0, e1, e2 = (pdev.cuda.Event(enable_timing=True) for _ in range(3))
    s1.wait_stream(pdev.current_stream())
    before = rn.rms_norm_fwd.launches
    with pdev.stream_guard(s1):
        on_s1 = torch.cuda.current_stream().cuda_stream == s1.cuda_stream
        e0.record(s1)
        side = F.rms_norm(x, w)
        e1.record(s1)
    s2.wait_event(e1)
    with pdev.stream_guard(s2):
        again = side.float().sum()
        e2.record(s2)
    pdev.current_stream().wait_stream(s2)
    e2.synchronize()
    k5_ms = e0.elapsed_time(e1)
    checks["K5a on a side stream under stream_guard == the default "
           "stream's, bitwise"] = on_s1 and torch.equal(side, ref) and \
        rn.rms_norm_fwd.launches == before + 1 and \
        again.item() == ref.float().sum().item()
    torch.cuda.reset_peak_memory_stats()
    big = torch.empty((1 << 28,), dtype=torch.uint8, device="cuda")
    del big
    pdev.synchronize()
    stats = pdev.memory_stats()
    checks["memory_stats peak_bytes_in_use == max_memory_allocated"] = \
        stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated() \
        and stats["bytes_in_use"] == torch.cuda.memory_allocated() and \
        stats["bytes_limit"] == torch.cuda.mem_get_info()[1]
    pt.set_flags({"FLAGS_check_nan_inf": 1})
    try:
        bad = pt.to_tensor(np.array([1.0, 0.0], np.float32), place="gpu")
        raised = False
        try:
            pt.log(bad - 1.0)
        except FloatingPointError:
            raised = True
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": 0})
    checks["FLAGS_check_nan_inf makes a NaN on the card raise"] = \
        raised and pt.get_flags(["FLAGS_check_nan_inf"]) == \
        {"FLAGS_check_nan_inf": "0"}
    t0 = time.perf_counter()
    master = runtime.TCPStore(is_master=True, port=0)
    client = runtime.TCPStore(host="127.0.0.1", port=master.port)
    try:
        master.set("unique_id", b"\x01\x02card")
        checks["TCPStore set / get / add on localhost"] = \
            client.get("unique_id") == b"\x01\x02card" and \
            client.add("n", 5) == 5 and master.add("n", 2) == 7
    finally:
        client.close()
        master.close()
    store_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ext_") as d:
        src = os.path.join(d, "cube.cc")
        with open(src, "w") as f:
            f.write(HOST_EXT)
        t0 = time.perf_counter()
        ext = cpp_extension.load("cube_ext", [src], build_directory=d)
        build_s = time.perf_counter() - t0
        cube = ext.elementwise_op("cube_fwd", grad_symbol="cube_bwd")
        v = torch.linspace(-2, 2, 1000, device="cuda").requires_grad_()
        y = cube(v)
        y.sum().backward()
        checks["cpp_extension op on a card tensor: values and gradient"] = \
            y.device.type == "cuda" and torch.equal(y, v.detach() ** 3) \
            and torch.allclose(v.grad, 3 * v.detach() ** 2, rtol=1e-6,
                               atol=0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_check()
    checks["run_check on the card"] = "gpu" in out.getvalue()
    log(f"host [{card}]: K5a on a side stream {k5_ms:.4f} ms (events); "
        f"memory_stats {stats}; TCPStore round trip {store_ms:.1f} ms; the "
        f"extension built in {build_s:.2f} s; run_check: "
        f"{out.getvalue().strip()}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"host: check failed: {name}")


# The tolerances of vision_parity, the card against the CPU in f32 with
# TF32 off: the models' logits of their largest |value|, the loss of
# max(1, |loss|), each gradient element of its tensor's largest |value|
# (floored at 1e-3 of the model's largest gradient: a tensor whose
# gradient is ~0 in exact arithmetic is rounding noise on both sides).
# That needs every ReLU / ReLU6 input on the same side of its kinks on
# both devices: one within rounding of a kink can fall on the other side
# and move a term of a gradient whole (0.8% of a batch-norm weight's
# largest at MobileNetV2's 2 x 2 last maps, where a channel sums 8 terms:
# 1 of 338,304 inputs did so on the card). So the CPU's run takes the
# card's side at each kink (``vision_model_run``'s ``sides``); each input
# it moves must lie within ``VISION_KINK_TOL`` of its layer's largest
# |input| from the kink on the CPU, and at most ``VISION_MAX_FLIPS`` a
# model. The detection ops' values and input gradients of their largest
# |value|; the spectra of their largest |value| (cuFFT against
# pocketfft).
VISION_TOL = {"logits": 1e-4, "loss": 1e-4, "grad": 1e-3, "op": 1e-5,
              "op_grad": 1e-4, "spectral": 1e-5}
VISION_GRAD_FLOOR = 1e-3
VISION_KINK_TOL = 1e-5
VISION_MAX_FLIPS = 8
# the vision phase: PaddleClas's ImageNet ResNet50 recipe
# (ppcls/configs/ImageNet/ResNet/ResNet50.yaml: 64 images a card,
# Momentum 0.9, L2 1e-4, 224 x 224; its rate 0.1 is for 256 images, four
# cards' batches, so one card's 64 takes 0.025 by the linear rule: at 0.1
# the loss on one fixed batch rose over the 13 steps on an H100, 7.41 ->
# 8.36; ``vision_rate_witness`` shows that torch's own SGD and batch norm
# rise the same way there) and MobileNetV2 under AdamW as
# tests/test_vision_zoo.py trains it; the data path over JPEGs it writes
VISION = {"B": 64, "size": 224, "steps": 10, "warmup": 2, "lr": 0.025,
          "witness_lr": 0.1, "witness_steps": 6, "jpegs": 128,
          "jpeg_size": 256, "workers": 4, "classes": 4, "roi_boxes": 512,
          "roi_map": (2, 256, 50, 84), "roi_stride": 16, "nms_boxes": 2000}
# the witness: a step of the port's Momentum over its batch norm against
# one of torch.optim.SGD over torch's batch_norm from the same state, the
# loss of max(1, |loss|), the parameters after the step by the norm of
# their difference over the norm of the step. At seed 0's weights the f32
# gradients themselves are that far apart: on the CPU at 16 x 224 x 224
# the port's and torch's batch norms give gradients 2.1% and 1.9% off an
# f64 evaluation by that norm (1.6% apart; conv1 and layer1 lead, their
# sums over every pixel cancelling under batch norm), and layer4's
# convolutions 10-13% tensor by tensor. A wrong momentum, sign or batch
# norm moves the step by tens of percent.
WITNESS_TOL = {"loss": 1e-4, "update": 5e-2}
VISION_MEAN = [0.485, 0.456, 0.406]
VISION_STD = [0.229, 0.224, 0.225]


def vision_model_run(torch, pt, model, x, y, sides=None):
    """One eval-mode forward, cross-entropy loss and backward: (logits,
    loss, {name: gradient}, the side of its kinks each ReLU / ReLU6 input
    element fell on (0: at or below 0; 1: between; 2: at or above
    ReLU6's 6), in call order, and for each element whose side differs
    from ``sides`` its distance from that kink, of its layer's largest
    |input|). Given ``sides`` (another run's), each activation takes
    that run's side: its value where the sides agree (bit for bit what
    the activation gives), its input, 0 or 6 where they differ, and the
    gradient of that side."""
    model.eval()
    for p in model.parameters():
        p.grad = None
    seen, flips = [], []

    def side(layer, inputs, outputs):
        v = inputs[0]
        hi = 6.0 if isinstance(layer, pt.nn.ReLU6) else math.inf
        own = ((v > 0).to(torch.int8) + (v >= hi).to(torch.int8)).detach()
        seen.append(own.cpu())
        if sides is None:
            return None
        want = sides[len(seen) - 1].to(v.device)
        moved = want != own
        if moved.any():
            kink = torch.where(want + own >= 3, hi, 0.0)[moved]
            scale = max(v.detach().abs().max().item(), 1e-30)
            flips.extend(((v.detach()[moved] - kink).abs() / scale)
                         .tolist())
        return torch.where(want == 1, v, torch.where(
            want == 0, torch.zeros_like(v), torch.full_like(v, hi)))

    hooks = [m.register_forward_post_hook(side)
             for m in model.sublayers()
             if isinstance(m, (pt.nn.ReLU, pt.nn.ReLU6))]
    try:
        logits = model(x)
    finally:
        for h in hooks:
            h.remove()
    loss = pt.nn.functional.cross_entropy(logits, y)
    loss.backward()
    return logits.detach(), loss.detach(), {
        n: p.grad.detach().clone() for n, p in model.named_parameters()}, \
        seen, flips


def vision_op_rows(torch, np):
    """(name, function of tensors, numpy inputs, positions whose
    gradients are compared) for the detection ops at small sizes."""
    from paddle_tpu_torch.vision import ops as vo
    rng = np.random.default_rng(0)

    def boxes(n, size):
        xy = rng.uniform(0, size * 0.7, (n, 2))
        wh = rng.uniform(0.5, size * 0.5, (n, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    feat = rng.standard_normal((2, 8, 16, 20)).astype(np.float32)
    bx = boxes(10, 16.0)
    num = np.array([5, 5], np.int32)
    x = rng.standard_normal((2, 4, 9, 8)).astype(np.float32)
    w = (0.3 * rng.standard_normal((6, 4, 3, 3))).astype(np.float32)
    off = (0.7 * rng.standard_normal((2, 36, 9, 8))).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 18, 9, 8)).astype(np.float32)
    yolo_x = (0.5 * rng.standard_normal((2, 21, 6, 6))).astype(np.float32)
    gt = np.array([[[0.5, 0.5, 0.2, 0.3], [0.1, 0.8, 0.1, 0.1]],
                   [[0.9, 0.2, 0.3, 0.2], [0.0, 0.0, 0.0, 0.0]]],
                  np.float32)
    label = np.array([[1, 0], [1, 0]], np.int64)
    return [
        ("roi_align adaptive aligned", lambda f, b: vo.roi_align(
            f, b, num, 3, spatial_scale=1.0), [feat, bx], (0, 1)),
        ("roi_align 2x2 unaligned 1/2", lambda f, b: vo.roi_align(
            f, b, num, (2, 3), spatial_scale=0.5, sampling_ratio=2,
            aligned=False), [feat, bx], (0, 1)),
        ("roi_pool", lambda f, b: vo.roi_pool(f, b, num, 2), [feat, bx],
         (0,)),
        ("psroi_pool", lambda f, b: vo.psroi_pool(f, b, num, 2), [feat, bx],
         (0,)),
        ("deform_conv2d groups 2, v2", lambda a, o, k, m: vo.deform_conv2d(
            a, o, k, padding=1, deformable_groups=2, mask=m),
         [x, off, w, mask], (0, 1, 2, 3)),
        ("yolo_loss", lambda a: vo.yolo_loss(
            a, gt, label, anchors=[10, 13, 16, 30, 33, 23],
            anchor_mask=[0, 1, 2], class_num=2, ignore_thresh=0.5,
            downsample_ratio=32), [yolo_x], (0,)),
    ]


def vision_op_run(torch, np, fn, inputs, diff, device):
    ts = [torch.tensor(a, device=device, requires_grad=i in diff)
          for i, a in enumerate(inputs)]
    out = fn(*ts)
    w = torch.tensor(np.random.default_rng(1).standard_normal(
        tuple(out.shape)).astype(np.float32), device=device)
    (out * w).sum().backward()
    return out.detach(), [ts[i].grad for i in diff]


def vision_spectra(torch, np, pt, device):
    """rfftn / ihfftn of [4, 32, 48] and stft / istft (hann, 512 / 128)
    of [4, 4096], on ``device``."""
    x = np.random.default_rng(2).standard_normal((4, 32, 48)).astype(
        np.float32)
    sig = np.random.default_rng(3).standard_normal((4, 4096)).astype(
        np.float32)
    win = torch.tensor(np.hanning(513)[:-1].astype(np.float32),
                       device=device)
    xt, st = torch.tensor(x, device=device), torch.tensor(sig, device=device)
    spec = pt.signal.stft(st, 512, 128, window=win)
    return {"rfftn": pt.fft.rfftn(xt), "ihfftn": pt.fft.ihfftn(xt),
            "stft": spec, "istft": pt.signal.istft(spec, 512, 128,
                                                    window=win,
                                                    length=4096)}


def phase_vision_parity(torch, np, card):
    """Phase vision_parity (docstring item 46)."""
    import copy
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.vision import models as vm
    from paddle_tpu_torch.vision import ops as vo
    checks = {}
    t_phase = time.perf_counter()
    log(f"vision_parity: f32 with cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    try:
        pt.set_device("cpu")
        pt.seed(0)
        models = {"resnet18": vm.resnet18(num_classes=10),
                  "mobilenet_v2": vm.mobilenet_v2(scale=0.25,
                                                  num_classes=10)}
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
        y = rng.integers(0, 10, 2)
        for name, cpu_m in models.items():
            card_m = copy.deepcopy(cpu_m).to("cuda")
            zero_counts()
            c = vision_model_run(torch, pt, card_m,
                                 torch.tensor(x, device="cuda"),
                                 torch.tensor(y, device="cuda"))
            torch.cuda.synchronize()
            counts = read_counts()
            h = vision_model_run(torch, pt, cpu_m, torch.tensor(x),
                                 torch.tensor(y), sides=c[3])
            lerr = nn_scaled_err(torch, c[0], h[0])
            loss_err = abs(c[1].item() - h[1].item()) / max(
                1.0, abs(h[1].item()))
            gmax = max(g.abs().max().item() for g in h[2].values())
            gerr = {k: nn_scaled_err(torch, c[2][k], g,
                                     VISION_GRAD_FLOOR * gmax)
                    for k, g in h[2].items()}
            worst = max(gerr, key=gerr.get)
            log(f"vision_parity {name} [{card}]: "
                f"{sum(p.numel() for p in cpu_m.parameters())} parameters, "
                f"eval on [2, 3, 64, 64]: logits {lerr:.3g} of their "
                f"largest, loss {loss_err:.3g} ({h[1].item():.6f}), "
                f"largest gradient error {gerr[worst]:.3g} ({worst}) over "
                f"{len(gerr)} tensors; {len(h[4])} of "
                f"{sum(r.numel() for r in c[3])} ReLU inputs fell on the "
                f"other side of a kink on the CPU and took the card's, "
                f"the farthest {max(h[4], default=0.0):.3g} of its layer's "
                f"largest from the kink; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            checks[f"{name}: logits within {VISION_TOL['logits']}, loss "
                   f"within {VISION_TOL['loss']}, gradients within "
                   f"{VISION_TOL['grad']}"] = (
                lerr <= VISION_TOL["logits"]
                and loss_err <= VISION_TOL["loss"]
                and gerr[worst] <= VISION_TOL["grad"])
            checks[f"{name}: no port kernel in eval"] = not any(
                counts.values())
            checks[f"{name}: at most {VISION_MAX_FLIPS} ReLU inputs moved "
                   f"to the card's side, each within {VISION_KINK_TOL} of "
                   f"its kink"] = len(h[4]) <= VISION_MAX_FLIPS and max(
                       h[4], default=0.0) <= VISION_KINK_TOL
            del card_m
        # MobileNetV2's Dropout(0.2): R2's mask on the card = the CPU's
        drop = models["mobilenet_v2"].classifier[0]
        drop.train()
        outs, fills = [], None
        a = np.random.default_rng(5).standard_normal((64, 1280)).astype(
            np.float32)
        g = np.random.default_rng(6).standard_normal((64, 1280)).astype(
            np.float32)
        for dev in ("cuda", "cpu"):
            pt.seed(11)
            t = torch.tensor(a, device=dev, requires_grad=True)
            if dev == "cuda":
                zero_counts()
            out = drop(t)
            out.backward(torch.tensor(g, device=dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                fills = read_counts()["r2_dropout"]
            outs.append((out.detach().cpu(), t.grad.cpu()))
        same = torch.equal(outs[0][0], outs[1][0]) and torch.equal(
            outs[0][1], outs[1][1])
        kept = (outs[1][0] != 0).float().mean().item()
        log(f"vision_parity dropout p 0.2 on [64, 1280]: kept {kept:.4f}; "
            f"output and input gradient bit for bit the CPU's {same}; R2 "
            f"dropout launches {fills}")
        checks["MobileNetV2's dropout: mask and gradient bit for bit the "
               "CPU's, R2 forward 1 + backward 1"] = same and fills == 2
        # the detection ops
        pt.set_device("gpu")
        boxes = np.random.default_rng(7).uniform(0, 60, (500, 2))
        boxes = np.concatenate([boxes, boxes + np.random.default_rng(8)
                                .uniform(2, 30, (500, 2))], 1).astype(
            np.float32)
        scores = np.random.default_rng(9).choice(
            np.linspace(0.05, 0.95, 19), 500).astype(np.float32)
        keep = [vo.nms(torch.tensor(boxes, device=dev), 0.5,
                       torch.tensor(scores, device=dev)).cpu()
                for dev in ("cuda", "cpu")]
        log(f"vision_parity nms: 500 boxes, scores with ties, kept "
            f"{keep[0].numel()}, equal to the CPU's "
            f"{torch.equal(*keep)}")
        checks["nms: indices equal to the CPU's"] = torch.equal(*keep)
        fails = []
        for name, fn, inputs, diff in vision_op_rows(torch, np):
            co, cg = vision_op_run(torch, np, fn, inputs, diff, "cuda")
            ho, hg = vision_op_run(torch, np, fn, inputs, diff, "cpu")
            fin = torch.isfinite(ho)
            err = nn_scaled_err(torch, torch.where(fin, co.cpu(), 0.0),
                                torch.where(fin, ho, 0.0), 1e-30)
            same_inf = torch.equal(torch.isfinite(co.cpu()), fin)
            gerr = max(nn_scaled_err(torch, a, b, 1e-30)
                       for a, b in zip(cg, hg))
            log(f"vision_parity {name}: value {err:.3g}, input gradients "
                f"{gerr:.3g} of their largest")
            if not (err <= VISION_TOL["op"] and same_inf
                    and gerr <= VISION_TOL["op_grad"]):
                fails.append(name)
        checks[f"detection ops within {VISION_TOL['op']} (values) and "
               f"{VISION_TOL['op_grad']} (gradients)"] = not fails
        # a JPEG written here, read to the card and decoded
        with tempfile.TemporaryDirectory() as tmp:
            from PIL import Image
            path = os.path.join(tmp, "img.jpg")
            Image.fromarray(np.random.default_rng(10).integers(
                0, 256, (37, 53, 3)).astype(np.uint8)).save(path,
                                                             quality=90)
            raw = vo.read_file(path)
            img = vo.decode_jpeg(raw)
            pt.set_device("cpu")
            ref = vo.decode_jpeg(vo.read_file(path))
        same = img.numpy().tobytes() == ref.numpy().tobytes()
        log(f"vision_parity decode_jpeg: {list(img.shape)} on "
            f"{img.value.device}, bytes equal to the CPU's {same}")
        checks["decode_jpeg: the card's bytes the CPU's"] = same and \
            img.value.device.type == "cuda"
        spec = [vision_spectra(torch, np, pt, dev) for dev in ("cuda", "cpu")]
        serr = {k: nn_scaled_err(torch, torch.view_as_real(v).cpu()
                                 if v.is_complex() else v.cpu(),
                                 torch.view_as_real(spec[1][k])
                                 if v.is_complex() else spec[1][k])
                for k, v in spec[0].items()}
        log(f"vision_parity fft and signal: card against CPU "
            f"{ {k: float(f'{v:.3g}') for k, v in serr.items()} }")
        checks[f"fft and signal within {VISION_TOL['spectral']}"] = \
            max(serr.values()) <= VISION_TOL["spectral"]
    finally:
        tdevice._default[0] = None
    log(f"vision_parity phase {time.perf_counter() - t_phase:.1f} s; "
        f"checks {checks}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"vision_parity: check failed: {name}")


def vision_steps(torch, pt, model, opt, x, y, tag):
    """``VISION["warmup"]`` steps, then ``VISION["steps"]`` timed with the
    counters zeroed just before and read just after, then one traced by
    the port's profiler inside a ``RecordEvent``: (losses, ms a step,
    counts, peak GiB, trace kernels {name: [n, ms]}, the range seen,
    traced ms)."""
    from paddle_tpu_torch.profiler import Profiler, RecordEvent
    F = pt.nn.functional
    model.train()

    def step():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [step() for _ in range(VISION["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(VISION["steps"]):
        losses.append(step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = Profiler()
    with prof:
        t1 = time.perf_counter()
        with RecordEvent(f"{tag}_train_step"):
            losses.append(step())
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    kernels, ranges = trace_events(prof.export())
    return ([v.item() for v in losses], wall / VISION["steps"] * 1e3,
            counts, peak, kernels, f"{tag}_train_step" in ranges, traced_ms)


def vision_rate_witness(torch, pt, x, y):
    """ResNet-50 at PaddleClas's own rate, ``Momentum(0.1, 0.9)`` with L2
    1e-4, from seed 0's weights on the fixed batch, beside plain torch:
    ``VISION["witness_steps"]`` steps of the port; before each, a twin
    with torch's ``F.batch_norm`` (cuDNN) in place of the port's batch
    norm takes the port's weights and velocity and one
    ``torch.optim.SGD(momentum=0.9, weight_decay=1e-4)`` step. Then the
    twin runs free from the same weights with SGD. Returns (the port's
    losses, the twin's free losses, the largest loss difference of a
    step and the largest parameter difference after a step, in
    ``WITNESS_TOL``'s measures)."""
    import copy
    import functools
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as vm
    F = pt.nn.functional
    lr, mu, wd = VISION["witness_lr"], 0.9, 1e-4
    pt.seed(0)
    model = vm.resnet50()
    model.train()
    twin = copy.deepcopy(model)

    def plain_bn(m, v):
        return torch.nn.functional.batch_norm(
            v, None, None, m.weight, m.bias, training=True, eps=m.epsilon)

    for m in twin.sublayers():
        if isinstance(m, pt.nn.BatchNorm2D):
            m.forward = functools.partial(plain_bn, m)
    params, tparams = list(model.parameters()), list(twin.parameters())
    init = [p.detach().clone() for p in params]
    opt = Momentum(learning_rate=lr, momentum=mu, parameters=params,
                   weight_decay=wd)
    losses, loss_err, upd_err = [], 0.0, 0.0
    for _ in range(VISION["witness_steps"]):
        vel = opt.state_dict().get("state", {}).get("velocity")
        sgd = torch.optim.SGD(tparams, lr=lr, momentum=mu, weight_decay=wd)
        with torch.no_grad():
            for i, (p, q) in enumerate(zip(params, tparams)):
                q.copy_(p)
                if vel is not None:
                    sgd.state[q]["momentum_buffer"] = vel[str(i)].clone()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        tloss = torch.nn.functional.cross_entropy(twin(x), y)
        tloss.backward()
        sgd.step()
        sgd.zero_grad(set_to_none=True)
        losses.append(loss.item())
        loss_err = max(loss_err, abs(tloss.item() - loss.item())
                       / max(1.0, abs(loss.item())))
        vel = opt.state_dict()["state"]["velocity"]
        with torch.no_grad():
            diff = sum((q - p).double().square().sum()
                       for p, q in zip(params, tparams))
            step = sum(v.double().square().sum() for v in vel.values())
            upd_err = max(upd_err, (diff / step).sqrt().item() / lr)
    del model, opt
    with torch.no_grad():
        for q, a in zip(tparams, init):
            q.copy_(a)
    sgd = torch.optim.SGD(tparams, lr=lr, momentum=mu, weight_decay=wd)
    free = []
    for _ in range(VISION["witness_steps"]):
        tloss = torch.nn.functional.cross_entropy(twin(x), y)
        tloss.backward()
        sgd.step()
        sgd.zero_grad(set_to_none=True)
        free.append(tloss.item())
    return losses, free, loss_err, upd_err


def write_jpeg_classes(np, root, n, size, classes):
    """``n`` seeded ``size`` x ``size`` RGB JPEGs in ``classes`` class
    folders under ``root`` (smooth gradients plus noise, as photos
    compress)."""
    from PIL import Image
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        d = os.path.join(root, f"class{i % classes}")
        os.makedirs(d, exist_ok=True)
        base = rng.uniform(0, 255, 3)[None, None, :] * (
            0.5 + 0.5 * np.stack([yy, xx, 1 - yy], -1))
        img = np.clip(base + rng.normal(0, 12, (size, size, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(d, f"{i:04d}.jpg"), quality=90)


def phase_vision(torch, np, card, record):
    """Phase vision (docstring item 47)."""
    import gc
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.ops.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.optimizer import AdamW, Momentum
    from paddle_tpu_torch.vision import datasets, transforms as T
    from paddle_tpu_torch.vision import models as vm
    from paddle_tpu_torch.vision import ops as vo
    gc.collect()
    torch.cuda.empty_cache()
    checks = {}
    B, S, n = VISION["B"], VISION["size"], VISION["steps"]
    log(f"vision: f32, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"batch {B} x 3 x {S} x {S}, {VISION['warmup']} warm-up, {n} timed "
        f"and 1 traced step on one fixed batch from seed 0")
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((B, 3, S, S)).astype(np.float32),
                     device="cuda")
    y = torch.tensor(rng.integers(0, 1000, B), device="cuda")
    results = {}
    for name in ("resnet50", "mobilenet_v2"):
        pt.seed(0)
        model = getattr(vm, name)()
        n_params = sum(p.numel() for p in model.parameters())
        if name == "resnet50":
            opt = Momentum(learning_rate=VISION["lr"], momentum=0.9,
                           parameters=model.parameters(), weight_decay=1e-4)
            desc = f"Momentum({VISION['lr']}, 0.9), weight decay 1e-4"
        else:
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
            desc = "AdamW(1e-3)"
        losses, step_ms, counts, peak_gb, kernels, ranged, traced_ms = \
            vision_steps(torch, pt, model, opt, x, y, name)
        busy = sum(ms for _, ms in kernels.values())
        launches = sum(k for k, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        n_tensors = len(list(model.parameters()))
        drops = sum(1 for m in model.sublayers()
                    if isinstance(m, pt.nn.Dropout) and m.p > 0)
        # what the code launches: one fused AdamW step a step, R2's
        # dropout once a Dropout forward and once its backward
        want = {"opt": n if name == "mobilenet_v2" else 0,
                "opt_kernels": n * mta.kernels_per_step(n_tensors, False)
                if name == "mobilenet_v2" else 0,
                "r2_dropout": 2 * drops * n, "r2_fill": 0}
        got = {k: counts[k] for k in want}
        others = {k: v for k, v in counts.items() if v and k not in want}
        log(f"vision {name} ({n_params} parameters, 1000 classes, {desc}) "
            f"[{card}]: {step_ms:.1f} ms a step, {B / step_ms * 1e3:.0f} "
            f"images/s, peak {peak_gb:.2f} GiB; the traced step's kernels "
            f"{busy:.1f} ms in {launches} launches: device busy "
            f"{100 * busy / step_ms:.1f}% of an untraced step "
            f"({100 * busy / traced_ms:.1f}% of the traced step's "
            f"{traced_ms:.1f} ms wall); losses "
            f"{[round(v, 4) for v in losses]}")
        log(f"vision {name} launches over {n} steps: {got}, want {want} "
            f"({drops} Dropout layers, {n_tensors} tensors); other kernels "
            f"{others}; the most time in: " + ", ".join(
                f"{k[:70]} {ms:.3f} ms ({c}x)" for k, (c, ms) in top))
        checks[f"{name}: losses finite and falling"] = \
            all(np.isfinite(losses)) and losses[-1] < losses[0]
        checks[f"{name}: launches {want}, no other port kernel"] = \
            got == want and not others
        checks[f"{name}: the trace holds the RecordEvent"] = ranged
        results[name] = (step_ms, counts)
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
        if name == "resnet50":
            wl, free, loss_err, upd_err = vision_rate_witness(torch, pt, x, y)
            log(f"vision resnet50 at Momentum({VISION['witness_lr']}, 0.9), "
                f"weight decay 1e-4 [{card}]: the port's losses "
                f"{[round(v, 4) for v in wl]}; a step of torch.optim.SGD "
                f"over torch's batch_norm from the port's state: loss "
                f"within {loss_err:.3g}, parameters within {upd_err:.3g}; "
                f"run free {[round(v, 4) for v in free]}")
            checks[f"resnet50 at {VISION['witness_lr']}: each step torch's "
                   f"SGD and batch norm's within {WITNESS_TOL}, and both "
                   f"rise"] = (
                loss_err <= WITNESS_TOL["loss"]
                and upd_err <= WITNESS_TOL["update"]
                and wl[-1] > wl[0] and free[-1] > free[0])
            gc.collect()
            torch.cuda.empty_cache()
    record["multi_tensor_adam"]["vision_launches"] = \
        results["mobilenet_v2"][1]["opt"]
    record["threefry_fill"]["vision_launches"] = \
        results["mobilenet_v2"][1]["r2_dropout"]
    # the data path: JPEGs -> DatasetFolder -> transforms -> DataLoader
    # workers -> hapi.Model.fit, MobileNetV2 under AdamW
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_jpeg_classes(np, tmp, VISION["jpegs"], VISION["jpeg_size"],
                           VISION["classes"])
        write_s = time.perf_counter() - t0
        tf = T.Compose([T.RandomResizedCrop(S), T.RandomHorizontalFlip(),
                        T.ToTensor(), T.Normalize(VISION_MEAN, VISION_STD)])
        ds = datasets.DatasetFolder(tmp, transform=tf)
        loader = DataLoader(ds, batch_size=B, shuffle=True, drop_last=True,
                            num_workers=VISION["workers"])
        t0 = time.perf_counter()
        shapes = [tuple(b[0].shape) for b in loader]
        load_s = time.perf_counter() - t0
        pt.seed(0)
        net = vm.mobilenet_v2(num_classes=VISION["classes"])
        model = Model(net)
        model.prepare(optimizer=AdamW(learning_rate=1e-3,
                                      parameters=net.parameters()),
                      loss=pt.nn.CrossEntropyLoss())
        rec = FitRecorder()
        zero_counts()
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
    steps = len(rec.losses)
    waits = [b - e for b, e in zip(rec.begins[1:], rec.ends[:-1])]
    fit_want = {"opt": steps, "r2_dropout": 2 * steps, "r2_fill": 0}
    log(f"vision data path [{card}]: {VISION['jpegs']} JPEGs "
        f"{VISION['jpeg_size']} x {VISION['jpeg_size']} written in "
        f"{write_s:.2f} s; DatasetFolder + RandomResizedCrop({S}), "
        f"RandomHorizontalFlip, ToTensor, Normalize through DataLoader("
        f"num_workers={VISION['workers']}): one epoch alone {shapes} in "
        f"{load_s:.2f} s, {VISION['jpegs'] / load_s:.0f} images/s (the "
        f"workers' start included); Model.fit: {steps} steps in "
        f"{fit_s:.2f} s, {B * steps / fit_s:.0f} images/s, losses "
        f"{[round(v, 4) for v in rec.losses]}, the loader's wait before "
        f"step 2 {1e3 * max(waits, default=0.0):.1f} ms; launches "
        f"{ {k: counts[k] for k in fit_want} }, want {fit_want}; the timed "
        f"MobileNetV2 step {results['mobilenet_v2'][0]:.1f} ms, "
        f"{B / results['mobilenet_v2'][0] * 1e3:.0f} images/s")
    checks["fit: 2 steps, finite losses, launches as counted"] = (
        steps == VISION["jpegs"] // B and all(np.isfinite(rec.losses))
        and {k: counts[k] for k in fit_want} == fit_want
        and all(s == (B, 3, S, S) for s in shapes))
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    # the detection ops at a detector's widths
    rng = np.random.default_rng(1)
    nb, (N, C, H, W) = VISION["roi_boxes"], VISION["roi_map"]
    scale = 1.0 / VISION["roi_stride"]
    feat = torch.tensor(rng.standard_normal((N, C, H, W)).astype(np.float32),
                        device="cuda", requires_grad=True)
    xy = rng.uniform(0, [W / scale * 0.8, H / scale * 0.8], (N * nb, 2))
    wh = rng.uniform(16, 256, (N * nb, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], 1).astype(
        np.float32), device="cuda")
    num = torch.tensor([nb] * N, dtype=torch.int32)
    nxy = rng.uniform(0, 1000, (VISION["nms_boxes"], 2))
    nms_boxes = torch.tensor(np.concatenate(
        [nxy, nxy + rng.uniform(16, 256, (VISION["nms_boxes"], 2))], 1
    ).astype(np.float32), device="cuda")
    nms_scores = torch.tensor(rng.uniform(0, 1, VISION["nms_boxes"]).astype(
        np.float32), device="cuda")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    timings = {}

    def detect(what):
        if what == "roi_align":
            out = vo.roi_align(feat, boxes, num, 7, spatial_scale=scale)
            torch.cuda.synchronize()
            fwd = time.perf_counter()
            out.sum().backward()
            return out, fwd
        return vo.nms(nms_boxes, 0.5, nms_scores), None

    for what in ("roi_align", "nms"):
        # the card's kernels counted under the profiler, then timed alone
        zero_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            detect(what)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, fwd = detect(what)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        timings[what] = (ms, kernels, read_counts(),
                         (fwd - t0) * 1e3 if fwd else None, out)
    ra, nm = timings["roi_align"], timings["nms"]
    log(f"vision detection widths [{card}]: roi_align of {N} x {nb} boxes "
        f"on [{N}, {C}, {H}, {W}] at 7 x 7 (1/{VISION['roi_stride']}, "
        f"adaptive grid) -> {list(ra[4].shape)}: forward {ra[3]:.1f} ms, "
        f"with backward {ra[0]:.1f} ms, {ra[1]} card kernels; nms of "
        f"{VISION['nms_boxes']} boxes (host numpy) {nm[0]:.1f} ms, "
        f"{nm[1]} card kernels, kept {nm[4].numel()}")
    checks["detection widths: no port kernel launched"] = not any(
        ra[2].values()) and not any(nm[2].values())
    log(f"vision checks {checks}")
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"vision: check failed: {name}")


def profile_once(torch, fn, card, what="train", unit="step"):
    """Where one call's time goes (a train step, an int8 forward): ``fn``
    once under torch.profiler, device time by kernel and the device's
    busy share of the wall time. Informational: it checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log(f"profile {what}: the profiler recorded no device time (not "
            f"measured)")
        return
    log(f"profile {what} [{card}]: one {unit} {wall_ms:.1f} ms wall (under "
        f"the profiler), device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(k[2] for k in kernels)} kernel "
        f"launches")
    for name, ms, count in kernels[:12]:
        log(f"  {ms:8.3f} ms/{unit}  {count:5d}x  {name[:90]}")
    # the port's own kernels (each library's anonymous namespace; PyTorch
    # has kernels there too, named with at:: or c10:: types), ranked or
    # not: K4's three and K5's in a train step
    # (a template kernel's name starts with its return type, void)
    anon = "(anonymous namespace)::"
    ours = [(name[name.index(anon) + len(anon):].split("(")[0], ms, count)
            for name, ms, count in kernels
            if name.startswith((anon, "void " + anon))
            and "at::" not in name and "c10::" not in name]
    log(f"profile {what}: the port's kernels, {sum(k[1] for k in ours):.3f} "
        f"ms/{unit}: " + ", ".join(f"{n} {ms:.3f} ms ({c}x)"
                                     for n, ms, c in ours))
    opt = [(n, ms, c) for n, ms, c in ours
           if n in ("update_kernel", "sumsq_kernel", "scale_kernel")]
    if opt:
        log(f"profile {what}: the optimizer's fused step "
            f"{sum(k[1] for k in opt):.3f} ms/{unit} in "
            f"{sum(k[2] for k in opt)} launches")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--parent", default=None,
                    help="a parent tree's root (git archive unpacked): the "
                         "rng phase times its R1 and R2 beside this tree's, "
                         "tensor_api its API cost a dispatched op")
    args = ap.parse_args()
    phases = [p for p in args.only.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "train_compose" in phases and "train" not in phases:
        ap.error("train_compose compares its losses with the train phase's: "
                 "run both")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke.py: the paddle_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    key, peak = peaks(name)
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rates = card_rates(torch)
    log(f"card rates: {rates['sms']} SMs at {rates['clock_mhz']:.0f} MHz "
        f"(nvidia-smi clocks.max.sm): " + ", ".join(
            f"{k} {rates[k] / 1e12:.2f}e12 instructions/s ({n} lanes an SM)"
            for k, n in LANES.items()))
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; bounds use "
        f"the {key} data-sheet figures ({peak[0] / 1e12} TB/s, "
        f"{peak[1] / 1e12:.0f} TFLOP/s bf16)")

    from paddle_tpu_torch.ops.kernels import _build
    t_build = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {time.perf_counter() - t_build:.1f} s wall, per source "
        f"{ {k: round(v, 1) for k, v in secs.items()} }")
    log(f"phase build {time.perf_counter() - t_build:.1f}")
    for stem, info in _build.build_log().items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {stem}: {line.strip()}")

    record = {
        "paged_attention": {
            "name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:124",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None},
        "ragged_prefill": {
            "name": "ragged_prefill", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_prefill.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_prefill.py:144",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None},
        "fused_tick": {
            "name": "fused_tick", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_tick.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_tick.py:215",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None},
    }
    for kname, src, tpu in (
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:98"),
            ("flash_attention_bwd", "flash_attention.cu",
             "flash_attention.py:248"),
            ("rms_norm_fwd", "rms_norm.cu", "rms_norm.py:42"),
            ("rms_norm_bwd", "rms_norm.cu", "rms_norm.py:91"),
            ("rope", "rope.cu", "rope.py:89"),
            ("gemm_epilogue", "gemm_epilogue.cu", "gemm_epilogue.py:72"),
            ("quant_matmul", "quant_matmul.cu", "quant_matmul.py:51")):
        record[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/pallas/{tpu}",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None}
    record["rope"].update(qk_ms=None, qk_backward_ms=None, qk_plain_ms=None,
                          qk_bound_ms=None)
    # the optimizer's fused step: the counterpart of an XLA fusion (the
    # reference's jitted multi-tensor update), not of a pallas_call
    record["multi_tensor_adam"] = {
        "name": "multi_tensor_adam", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/multi_tensor_adam.cu",
        "replaces": "paddle_tpu/optimizer/optimizer.py:62",
        "launches": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None}
    # the random kernels: counterparts of jnp over jax.random in jitted
    # programs, not of a pallas_call
    record["sample_rows"] = {
        "name": "sample_rows", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/sample_rows.cu",
        "replaces": "paddle_tpu/inference/continuous_batching.py:2555",
        "launches": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None, "argmax_ms": None}
    record["threefry_fill"] = {
        "name": "threefry_fill", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/threefry_fill.cu",
        "replaces": "paddle_tpu/nn/functional.py:208",
        "launches": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None, "gumbel_ulps": None}
    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        log(f"phase {name} {time.perf_counter() - t:.1f}")
        return out

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    if "k1" in phases:
        timed("k1", phase_k1, torch, peak, flush, record)
    if "k2" in phases:
        timed("k2", phase_k2, torch, peak, flush, record)
    if "k3" in phases:
        timed("k3", phase_k3, torch, peak, flush, record)
    if "k4" in phases:
        timed("k4", phase_k4, torch, peak, flush, record)
    if "k5" in phases:
        timed("k5", phase_k5, torch, peak, flush, record)
    if "k6" in phases:
        timed("k6", phase_k6, torch, peak, flush, record)
    if "k7" in phases:
        timed("k7", phase_k7, torch, peak, flush, record)
    if "k8" in phases:
        timed("k8", phase_k8, torch, peak, flush, record)
    if "opt" in phases:
        timed("opt", phase_opt, torch, np, peak, flush, record)
    if "rng" in phases:
        timed("rng", phase_rng, torch, np, peak, flush, record,
              args.parent)
    del flush
    if "parity" in phases:
        timed("parity", phase_parity, torch, np)
    if "dense_parity" in phases:
        timed("dense_parity", phase_dense_parity, torch, np)
    if "preempt_parity" in phases:
        timed("preempt_parity", phase_preempt_parity, torch, np)
    if "train_parity" in phases:
        timed("train_parity", phase_train_parity, torch, np)
    if "int8_parity" in phases:
        timed("int8_parity", phase_int8_parity, torch, np)
    model_7b, serve_res = None, None
    if "serve" in phases:
        torch.cuda.empty_cache()
        model_7b, serve_res = timed("serve", phase_serve, torch, np, card,
                                    record)
    if "dense" in phases:
        torch.cuda.empty_cache()
        model_7b = timed("dense", phase_dense, torch, np, card, record,
                         model_7b, serve_res)
    if "preempt" in phases:
        torch.cuda.empty_cache()
        model_7b = timed("preempt", phase_preempt, torch, np, card, record,
                         model_7b)
    if "telemetry" in phases:
        torch.cuda.empty_cache()
        model_7b = timed("telemetry", phase_telemetry, torch, np, card,
                         peak, record, model_7b, serve_res)
    if "fleet_parity" in phases:
        timed("fleet_parity", phase_fleet_parity, torch, np)
    if "fleet" in phases:
        torch.cuda.empty_cache()
        model_7b = timed("fleet", phase_fleet, torch, np, card, model_7b)
    if "wire_parity" in phases:
        timed("wire_parity", phase_wire_parity, torch, np)
    if "wire" in phases:
        torch.cuda.empty_cache()
        timed("wire", phase_wire, torch, np, card, model_7b, serve_res)
    if "family_parity" in phases:
        timed("family_parity", phase_family_parity, torch, np)
    if "families" in phases:
        torch.cuda.empty_cache()
        model_7b = timed("families", phase_families, torch, np, card, peak,
                         record, model_7b, serve_res)
    if "decode_parity" in phases:
        timed("decode_parity", phase_decode_parity, torch, np)
    if "decoding" in phases:
        torch.cuda.empty_cache()
        model_7b = timed("decoding", phase_decoding, torch, np, card,
                         model_7b)
    if "deploy" in phases:
        torch.cuda.empty_cache()
        timed("deploy", phase_deploy, torch, np, card, record)
    if "tensor_api" in phases:
        torch.cuda.empty_cache()
        timed("tensor_api", phase_tensor_api, torch, np, card, record,
              args.parent)
    if "nn_layers" in phases:
        torch.cuda.empty_cache()
        timed("nn_layers", phase_nn_layers, torch, np, card, peak, record)
    if "zoo_parity" in phases:
        timed("zoo_parity", phase_zoo_parity, torch, np, card)
    if "zoo" in phases:
        torch.cuda.empty_cache()
        timed("zoo", phase_zoo, torch, np, card, record, model_7b)
    if "int8_infer" in phases:
        timed("int8_infer", phase_int8_infer, torch, np, card, record,
              model_7b)
    del model_7b
    if "train" in phases:
        train = timed("train", phase_train, torch, np, card, peak, record)
    if "train_compose" in phases:
        timed("train_compose", phase_train_compose, torch, np, card, train)
    if "train_amp" in phases:
        timed("train_amp", phase_train_amp, torch, np, card, record)
    if "fit" in phases:
        timed("fit", phase_fit, torch, np, card, record,
              train if "train" in phases else None)
    if "static_jit" in phases:
        torch.cuda.empty_cache()
        timed("static_jit", phase_static_jit, torch, np, card, record)
    if "quant_parity" in phases:
        timed("quant_parity", phase_quant_parity, torch, np)
    if "quant" in phases:
        torch.cuda.empty_cache()
        timed("quant", phase_quant, torch, np, card, record,
              train if "train" in phases else None)
    if "moe_parity" in phases:
        timed("moe_parity", phase_moe_parity, torch, np)
    if "moe" in phases:
        torch.cuda.empty_cache()
        timed("moe", phase_moe, torch, np, card, peak, record)
    if "host" in phases:
        timed("host", phase_host, torch, np, card)
    if "vision_parity" in phases:
        timed("vision_parity", phase_vision_parity, torch, np, card)
    if "vision" in phases:
        torch.cuda.empty_cache()
        timed("vision", phase_vision, torch, np, card, record)
    log(json.dumps({"kernels": list(record.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
