"""paddle.incubate.nn's fused transformer layers.

Port of ``paddle_tpu/incubate/nn/fused_transformer.py``: each layer is
the reference's composition over the port's ``nn`` (``Linear``,
``LayerNorm``, ``Dropout``) and ``nn.functional``, with the attention on
the flash kernel (K4) where there is no mask and no attention dropout,
and dropout on R2 on the card. Parameters are drawn in the reference's
order by the same initializers, so ``seed()`` gives the reference's
weights. ``nranks`` / ``ring_id`` (tensor parallelism) are accepted and
not used, as in the reference.
"""
from ... import nn
from ...nn import functional as F
from ...nn.initializer import Constant, XavierNormal
from ...nn.layer import Layer, LayerList

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear", "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe"]


class FusedMultiHeadAttention(Layer):
    """(pre-LN), qkv projection, attention, output projection, dropout,
    residual, (post-LN); one LayerNorm serves either place."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim,
                             weight_attr=qkv_weight_attr,
                             bias_attr=qkv_bias_attr)
        self.out_proj = nn.Linear(embed_dim, embed_dim,
                                  weight_attr=linear_weight_attr,
                                  bias_attr=linear_bias_attr)
        self.ln = nn.LayerNorm(embed_dim, epsilon=epsilon)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        x = query
        residual = x
        if self.normalize_before:
            x = self.ln(x)
        b, s = x.shape[0], x.shape[1]
        hd = self.embed_dim // self.num_heads
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads, hd).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            is_causal=False, training=self.training)
        out = self.dropout(self.out_proj(out.reshape(b, s,
                                                     self.embed_dim)))
        out = residual + out
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(Layer):
    """(pre-LN), ``fc2(act_dropout(act(fc1(x))))``, dropout, residual,
    (post-LN)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.activation = activation
        self.fc1 = nn.Linear(d_model, dim_feedforward,
                             weight_attr=linear1_weight_attr,
                             bias_attr=linear1_bias_attr)
        self.fc2 = nn.Linear(dim_feedforward, d_model,
                             weight_attr=linear2_weight_attr,
                             bias_attr=linear2_bias_attr)
        self.ln = nn.LayerNorm(d_model, epsilon=epsilon)
        self.dropout = nn.Dropout(dropout_rate)
        self.act_dropout = nn.Dropout(act_dropout_rate
                                      if act_dropout_rate is not None
                                      else dropout_rate)

    def forward(self, src, cache=None):
        residual = src
        x = self.ln(src) if self.normalize_before else src
        act = getattr(F, self.activation)
        x = self.fc2(self.act_dropout(act(self.fc1(x))))
        out = residual + self.dropout(x)
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate if attn_dropout_rate
            is not None else dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(Layer):
    """The decoder stack as one module: ``num_layers`` encoder layers
    (pre-LN by default). ``caches`` and ``time_step`` are accepted and
    not used, as in the reference's layer (the functional
    ``fused_multi_transformer`` takes them)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, nranks=1, ring_id=-1, name=None, **kw):
        super().__init__()
        self.layers = LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=normalize_before)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x


class FusedLinear(Layer):
    """``x @ weight (+ bias)`` (``fused_linear``); ``transpose_weight``
    keeps the weight ``[out, in]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        shape = (out_features, in_features) if transpose_weight else \
            (in_features, out_features)
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True)
        self.transpose_weight = transpose_weight

    def forward(self, x):
        from .functional import fused_linear
        return fused_linear(x, self.weight, self.bias,
                            self.transpose_weight)


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``layer_norm(residual + dropout(x + linear_bias))``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.ln_scale = self.create_parameter(
            (embed_dim,), attr=weight_attr,
            default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter((embed_dim,), attr=bias_attr,
                                             is_bias=True)
        self.linear_bias = self.create_parameter((embed_dim,), is_bias=True)

    def forward(self, x, residual):
        from .functional import fused_bias_dropout_residual_layer_norm
        return fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            self.dropout_rate, self.epsilon, self.training)


class FusedEcMoe(Layer):
    """Expert-choice MoE over ``fused_ec_moe``: experts pick their top
    tokens, so capacity is exact and no auxiliary loss is needed."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None):
        super().__init__()
        init = XavierNormal()
        self.gate = self.create_parameter((hidden_size, num_experts),
                                          attr=weight_attr,
                                          default_initializer=init)
        self.w1 = self.create_parameter((num_experts, hidden_size,
                                         inter_size),
                                        default_initializer=init)
        self.b1 = self.create_parameter((num_experts, 1, inter_size),
                                        is_bias=True)
        self.w2 = self.create_parameter((num_experts, inter_size,
                                         hidden_size),
                                        default_initializer=init)
        self.b2 = self.create_parameter((num_experts, 1, hidden_size),
                                        is_bias=True)
        self.act_type = act_type
        self.num_experts = num_experts

    def forward(self, x, gate_logits=None):
        from .functional import fused_ec_moe
        gate = gate_logits if gate_logits is not None else self.gate
        return fused_ec_moe(x, gate, self.w1, self.b1, self.w2, self.b2,
                            self.act_type)
