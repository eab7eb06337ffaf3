"""Analytic FLOP and byte model of the paged serving programs of the
port's causal LMs (Llama, Mixtral, GPT): the prices
``telemetry.CostCatalog`` charges.

The JAX package prices its jitted serving programs with XLA's own
``cost_analysis``; the port's programs are eager calls into hand-written
kernels, so this module counts their work from the model's config and
the launch's shapes. Each price is ``(flops, bytes)`` of one launch,
over every layer:

- the matmuls: ``2 * M * N * K`` FLOPs for each weight matrix of a
  layer over the rows the launch really runs (``S * C`` for a ragged
  prefill or a fused pass of chunk width C, ``S`` for a decode step),
  and the head over one row a slot. Llama: q, k, v, o, gate, up, down.
  Mixtral: q, k, v, o, the router ``H x E`` and all E experts' gate,
  up and down (``_moe_topk_ffn`` runs every expert on every row). GPT:
  the fused qkv ``H x 3H``, the output projection, fc1 and fc2;
- each weight's bytes, read once a launch: every layer's matrices,
  norms (and GPT's biases), the final norm and the head (GPT's head is
  the tied token table). With ``weight_dtype="int8"`` each matrix the
  bundle quantizes is one byte a weight plus an f32 scale an output
  channel (and expert); the rest keeps the model's element size;
- the embedding rows the launch gathers (one a row; GPT's learned
  positions one more) and the K and V rows it writes into the pool
  (one each a row and layer), and the head's logits written (one row a
  slot, in the weights' type);
- attention, per layer, as the kernel's route reads it on the card
  (``AttentionCosts``, whose prices are the bounds ``chip_smoke.py``
  gives K1, K2 and K3): q's rows read and out's rows written, each K and V row
  the kernel reads once (a slot's keys up to its frontier: the bf16 and
  f32 routes read no column at or past it), the int32 table and
  schedule entries and the per-slot scalars; ``4 * keys * heads *
  head_dim`` FLOPs (the score and value products).

Not counted: activations between ops (norms, rope, the activations,
residual adds, the int8 dequantised copies: each a read and a write of
rows or weights already counted once), the sampler's passes over the
logits, and the elementwise FLOPs. So a price understates what the card
moves, and a tick's roofline ratio from these prices is a lower bound.

``row_nbytes`` is one token's K and V across every layer of the pool:
the unit the server's page gather and scatter transfer charges use.
"""
__all__ = ["AttentionCosts", "ServingCosts", "LlamaServingCosts",
           "MixtralServingCosts", "GPTServingCosts", "serving_costs"]


class AttentionCosts:
    """Prices of one layer's paged attention kernels (K1, K2, K3) for
    ``heads`` query heads over ``kv_heads`` of ``head_dim``, a pool of
    ``page_size``-token pages of ``cache_bytes``-byte elements and a
    block table ``table_pages`` wide. ``chip_smoke.py``'s bounds for the
    three kernels are these prices."""

    def __init__(self, heads, kv_heads, head_dim, page_size, table_pages,
                 cache_bytes):
        self.nh = int(heads)
        self.kvh = int(kv_heads)
        self.hd = int(head_dim)
        self.pg = int(page_size)
        self.W = int(table_pages)
        self.ce = int(cache_bytes)

    def k1(self, lengths):
        """Paged decode (K1) over keys ``lengths`` a slot (the decode
        step's ``t + 1``), each clamped to the table's span."""
        T, pg, e = self.W * self.pg, self.pg, self.ce
        keys = [min(max(int(n), 0), T) for n in lengths]
        toks = sum(keys)
        S = len(keys)
        nbytes = 2 * S * self.nh * self.hd * e \
            + 2 * toks * self.kvh * self.hd * e \
            + sum(-(-n // pg) for n in keys) * 4 + 4 * S
        return 4 * toks * self.nh * self.hd, nbytes

    def k2(self, slots, C):
        """Ragged prefill (K2) of width C over ``slots`` ``[(t0, n)]``:
        slot rows ``t0 .. t0 + n - 1`` up to its ``last`` (``n = 0``: an
        idle slot, skipped); row c sees keys ``<= min(t0 + c, T - 1)``."""
        T, pg, e = self.W * self.pg, self.pg, self.ce
        vis = kv_toks = rows = pages = 0
        for t0, n in slots:
            if n <= 0 or t0 >= T:
                continue
            rows += n
            vis += sum(min(t0 + c, T - 1) + 1 for c in range(n))
            k = min(t0 + n, T)
            kv_toks += k
            pages += -(-k // pg)
        nbytes = rows * self.nh * self.hd * e \
            + len(slots) * C * self.nh * self.hd * e \
            + 2 * kv_toks * self.kvh * self.hd * e + 12 * len(slots) \
            + pages * 4
        return 4 * vis * self.nh * self.hd, nbytes

    def k3_pages(self, slots):
        """Pages K3's schedule lists for ``slots`` ``[(t0, n, dec)]``:
        ``last // page_size + 1`` a live slot."""
        return sum(((t0 if dec else t0 + n - 1) // self.pg + 1)
                   for t0, n, dec in slots if n > 0)

    def k3(self, slots, C):
        """Fused tick (K3) of width C over ``slots`` ``[(t0, n, dec)]``
        (``n = 0``: idle): a decode row sees ``t0 + 1`` keys, prefill
        row c ``t0 + c + 1``; K and V are read as the schedule's whole
        pages (``k3_pages``)."""
        pg, e = self.pg, self.ce
        vis = rows = 0
        for t0, n, dec in slots:
            if n <= 0:
                continue
            if dec:
                rows += 1
                vis += t0 + 1
            else:
                rows += n
                vis += sum(t0 + c + 1 for c in range(n))
        n_live = self.k3_pages(slots)
        S = len(slots)
        nbytes = rows * self.nh * self.hd * e \
            + S * C * self.nh * self.hd * e \
            + 2 * n_live * pg * self.kvh * self.hd * e \
            + 4 * (3 * n_live + 2 * S)
        return 4 * vis * self.nh * self.hd, nbytes


class ServingCosts:
    """Prices of a paged bundle's launches from one layer's shape.

    ``matrices`` lists the weight matrices of a layer that the int8
    bundle quantizes, ``(K, N, copies)`` (the experts' ``copies`` is E);
    ``vectors`` counts its other weights, kept in full precision (norms,
    biases, Mixtral's router); ``embed_rows`` the table rows a row
    gathers (2 with learned positions), ``final`` the final norm's
    elements.
    ``weight_bytes`` and ``cache_bytes`` are the element sizes of the
    parameters and the page pool; ``int8_weights`` prices the matrices
    as the int8 bundle holds them (a byte a weight and an f32 scale a
    copy and output channel). ``page_size`` is the pool's page,
    ``table_pages`` the block table's width (a slot's keys are clamped
    to its span), ``slots`` the server's slot count S. ``attn`` holds a
    layer's attention prices."""

    def __init__(self, layers, hidden, vocab, attn, matrices, vectors,
                 final, weight_bytes, int8_weights, table_pages, slots,
                 embed_rows=1):
        self.L = int(layers)
        self.H = int(hidden)
        self.V = int(vocab)
        self.we = int(weight_bytes)
        self.W = int(table_pages)
        self.S = int(slots)
        self.attn = attn
        weights = sum(k * n * c for k, n, c in matrices)
        # weights of one layer: its matrices and vectors
        self.layer_params = weights + vectors
        self.row_flops = 2 * weights
        if int8_weights:
            layer_nbytes = weights + 4 * sum(n * c for _, n, c in matrices) \
                + vectors * self.we
        else:
            layer_nbytes = self.layer_params * self.we
        self.body_nbytes = self.L * layer_nbytes + final * self.we
        self.head_nbytes = self.H * self.V * self.we
        self.embed_rows = int(embed_rows)
        self.row_nbytes = 2 * self.L * attn.kvh * attn.hd * attn.ce

    # ------------------------------------------------- the dense parts
    def dense(self, rows, head_rows):
        """``(flops, bytes)`` of the projections, MLP and head of one
        launch over ``rows`` rows with ``head_rows`` head rows (0: no
        head, its weight not read), without attention."""
        flops = self.L * rows * self.row_flops \
            + 2 * head_rows * self.H * self.V
        nbytes = self.body_nbytes \
            + rows * self.embed_rows * self.H * self.we \
            + rows * self.row_nbytes
        if head_rows:
            nbytes += self.head_nbytes + head_rows * self.V * self.we
        return flops, nbytes

    # ------------------------------------------------------- launches
    def decode(self, t, steps=1):
        """One split decode call: ``steps`` decode steps over every slot,
        slot s at write position ``t[s]`` (its keys ``t + 1``), each step
        K1 a layer."""
        flops, nbytes = 0, 0
        for j in range(steps):
            f, b = self.dense(self.S, self.S)
            fa, ba = self.attn.k1([int(x) + j + 1 for x in t])
            flops += f + self.L * fa
            nbytes += b + self.L * ba
        return flops, nbytes

    def prefill(self, slots, C):
        """One ragged prefill launch of width C: every slot's C rows
        through the projections, K2 a layer, the head at one row a
        slot."""
        f, b = self.dense(self.S * C, self.S)
        fa, ba = self.attn.k2(slots, C)
        return f + self.L * fa, b + self.L * ba

    def fused(self, passes):
        """One fused-tick entry call: ``passes`` ``[(slots, C)]``, one
        pass a width (a tick with prefill chunks and decode rows runs
        the decode rows at C = 1 and the chunks at their width), each
        pass ``S * C`` rows and K3 a layer; the head once, a row a
        slot."""
        flops = 2 * self.S * self.H * self.V
        nbytes = self.head_nbytes + self.S * self.V * self.we
        for slots, C in passes:
            f, b = self.dense(self.S * C, 0)
            fa, ba = self.attn.k3(slots, C)
            flops += f + self.L * fa
            nbytes += b + self.L * ba
        return flops, nbytes


def _attention(cfg, kv_heads, page_size, table_pages, cache_bytes):
    return AttentionCosts(cfg.num_heads, kv_heads,
                          cfg.hidden_size // cfg.num_heads, page_size,
                          table_pages, cache_bytes)


class LlamaServingCosts(ServingCosts):
    """Prices of a ``LlamaForCausalLM``'s paged bundle: q, k, v, o,
    gate, up and down a layer, two norm scales, the final norm and an
    untied head."""

    def __init__(self, cfg, weight_bytes, cache_bytes, page_size,
                 table_pages, slots, int8_weights=False):
        attn = _attention(cfg, cfg.num_kv_heads, page_size, table_pages,
                          cache_bytes)
        H, I = cfg.hidden_size, cfg.intermediate_size
        q, kv = attn.nh * attn.hd, attn.kvh * attn.hd
        super().__init__(
            cfg.num_layers, H, cfg.vocab_size, attn,
            [(H, q, 1), (H, kv, 2), (q, H, 1), (H, I, 2), (I, H, 1)],
            2 * H, H, weight_bytes, int8_weights, table_pages, slots)


class MixtralServingCosts(ServingCosts):
    """Prices of a ``MixtralForCausalLM``'s paged bundle: the Llama
    attention, the router ``H x E`` (full precision under int8, as the
    bundle keeps it) and all E experts' gate, up and down a row."""

    def __init__(self, cfg, weight_bytes, cache_bytes, page_size,
                 table_pages, slots, int8_weights=False):
        attn = _attention(cfg, cfg.num_kv_heads, page_size, table_pages,
                          cache_bytes)
        H, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        q, kv = attn.nh * attn.hd, attn.kvh * attn.hd
        super().__init__(
            cfg.num_layers, H, cfg.vocab_size, attn,
            [(H, q, 1), (H, kv, 2), (q, H, 1), (H, I, 2 * E), (I, H, E)],
            2 * H + H * E, H, weight_bytes, int8_weights, table_pages,
            slots)
        self.row_flops += 2 * H * E            # the router's product


class GPTServingCosts(ServingCosts):
    """Prices of a ``GPTForCausalLM``'s paged bundle: the fused qkv
    ``H x 3H``, the output projection, fc1 and fc2 a layer, their
    biases, two LayerNorms (scale and shift), the final LayerNorm, the
    token and position rows a row gathers and the head tied to the
    token table; MHA (as many kv heads as heads)."""

    def __init__(self, cfg, weight_bytes, cache_bytes, page_size,
                 table_pages, slots, int8_weights=False):
        attn = _attention(cfg, cfg.num_heads, page_size, table_pages,
                          cache_bytes)
        H, I = cfg.hidden_size, cfg.intermediate_size
        super().__init__(
            cfg.num_layers, H, cfg.vocab_size, attn,
            [(H, 3 * H, 1), (H, H, 1), (H, I, 1), (I, H, 1)],
            (3 * H + H + I + H) + 4 * H, 2 * H, weight_bytes, int8_weights,
            table_pages, slots, embed_rows=2)


def serving_costs(model, cache_bytes, page_size, table_pages, slots,
                  weight_dtype=None):
    """The price model of ``model``'s paged bundle (``cache_bytes``: the
    pool's element size; ``weight_dtype="int8"``: the int8 bundle's
    weights), or None for a model the port has no model of (its calls
    are then priced as errors, as the reference prices a function it
    cannot lower)."""
    from .gpt import GPTForCausalLM
    from .llama import LlamaForCausalLM
    from .mixtral import MixtralForCausalLM
    kinds = ((MixtralForCausalLM, MixtralServingCosts),
             (LlamaForCausalLM, LlamaServingCosts),
             (GPTForCausalLM, GPTServingCosts))
    for cls, costs in kinds:
        if isinstance(model, cls):
            we = next(model.parameters()).element_size()
            return costs(model.cfg, we, cache_bytes, page_size,
                         table_pages, slots,
                         int8_weights=weight_dtype == "int8")
    return None
