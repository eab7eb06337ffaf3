"""Analytic FLOP and byte model of the paged serving programs of a Llama
model: the prices ``telemetry.CostCatalog`` charges.

The JAX package prices its jitted serving programs with XLA's own
``cost_analysis``; the port's programs are eager calls into hand-written
kernels, so this module counts their work from the model's config and
the launch's shapes. Each price is ``(flops, bytes)`` of one launch,
over every layer:

- projections and MLP: ``2 * M * N * K`` FLOPs for q, k, v, o, gate, up
  and down, over the rows the launch really runs (``S * C`` for a
  ragged prefill or a fused pass of chunk width C, ``S`` for a decode
  step), and the head over one row a slot;
- each weight's bytes, read once a launch: the seven projections and
  the two norm scales of every layer, the final norm and the head;
- the embedding rows the launch gathers (one a row) and the K and V
  rows it writes into the pool (one each a row and layer), and the head's
  logits written (one row a slot, in the weights' type);
- attention, per layer, as the kernel's route reads it on the card
  (``AttentionCosts``, whose prices are the bounds ``chip_smoke.py``
  gives K1, K2 and K3): q's rows read and out's rows written, each K and V row
  the kernel reads once (a slot's keys up to its frontier: the bf16 and
  f32 routes read no column at or past it), the int32 table and
  schedule entries and the per-slot scalars; ``4 * keys * heads *
  head_dim`` FLOPs (the score and value products).

Not counted: activations between ops (norm, rope, SwiGLU, residual
adds: each a read and a write of rows already counted once as the
projections' inputs), the sampler's passes over the logits, and the
elementwise FLOPs. So a price understates what the card moves, and a
tick's roofline ratio from these prices is a lower bound.

``row_nbytes`` is one token's K and V across every layer of the pool:
the unit the server's page gather and scatter transfer charges use.
"""
__all__ = ["AttentionCosts", "LlamaServingCosts", "serving_costs"]


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


class LlamaServingCosts:
    """Prices of the paged bundle's launches for one ``LlamaConfig``.

    ``weight_bytes`` and ``cache_bytes`` are the element sizes of the
    parameters and the page pool, ``page_size`` the pool's page,
    ``table_pages`` the block table's width (a slot's keys are clamped
    to its span), ``slots`` the server's slot count S. ``attn`` holds a
    layer's attention prices."""

    def __init__(self, cfg, weight_bytes, cache_bytes, page_size,
                 table_pages, slots):
        self.L = int(cfg.num_layers)
        self.H = int(cfg.hidden_size)
        self.I = int(cfg.intermediate_size)
        self.V = int(cfg.vocab_size)
        self.we = int(weight_bytes)
        self.W = int(table_pages)
        self.S = int(slots)
        self.attn = AttentionCosts(cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, page_size, table_pages,
                                   cache_bytes)
        H = self.H
        q = self.attn.nh * self.attn.hd
        kv = self.attn.kvh * self.attn.hd
        # weights of one layer: q, k, v, o, gate, up, down, two norms
        self.layer_params = H * q + 2 * H * kv + q * H + 3 * H * self.I \
            + 2 * H
        self.row_flops = 2 * (H * q + 2 * H * kv + q * H + 3 * H * self.I)
        self.body_nbytes = (self.L * self.layer_params + H) * self.we
        self.head_nbytes = H * self.V * self.we
        self.row_nbytes = 2 * self.L * kv * self.attn.ce

    # ------------------------------------------------- the dense parts
    def dense(self, rows, head_rows):
        """``(flops, bytes)`` of the projections, MLP and head of one
        launch over ``rows`` rows with ``head_rows`` head rows (0: no
        head, its weight not read), without attention."""
        flops = self.L * rows * self.row_flops \
            + 2 * head_rows * self.H * self.V
        nbytes = self.body_nbytes + rows * self.H * self.we \
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


def serving_costs(model, cache_bytes, page_size, table_pages, slots):
    """The price model of ``model``'s paged bundle (``cache_bytes``: the
    pool's element size), or None for a model the port has no model of
    (its calls are then priced as errors, as the reference prices a
    function it cannot lower)."""
    from .llama import LlamaForCausalLM
    if not isinstance(model, LlamaForCausalLM):
        return None
    we = next(model.parameters()).element_size()
    return LlamaServingCosts(model.cfg, we, cache_bytes, page_size,
                             table_pages, slots)
