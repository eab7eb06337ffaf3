"""BERT family (encoder-only, learned positions and token types, GELU):
port of ``paddle_tpu/models/bert.py``.

Built from the port's ``nn`` (``Embedding``, ``LayerNorm``, ``Dropout``,
``TransformerEncoder``, ``Linear``) under the JAX module's attribute and
parameter names, so ``models.bridge.load_jax_params`` carries a model
across name for name. Attention routes as the reference's does: the
encoder's ``MultiHeadAttention`` passes its dropout rate to
``scaled_dot_product_attention`` whether or not it is training, and a
rate or a mask takes the plain composition, so ``bert_base()`` (dropout
0.1) never reaches the flash-attention kernel (K4), in eval either;
``bert_tiny()`` (dropout 0) without a mask does. Dropout runs R2 on the
card.

The classes take a ``device=`` keyword (a paddle place or a torch
device; None: the default place, the card unless ``set_device`` chose
another): every parameter is made there.
"""
from dataclasses import dataclass

import torch

from .. import nn
from ..device import default_place
from ..nn import functional as F

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_base", "bert_tiny"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                            cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertModel(nn.Layer):
    """Returns (sequence_output ``[B, S, H]``, pooled_output ``[B, H]``)."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        with default_place(device):
            self.embeddings = BertEmbeddings(cfg)
            layer = nn.TransformerEncoderLayer(
                d_model=cfg.hidden_size, nhead=cfg.num_heads,
                dim_feedforward=cfg.intermediate_size, dropout=cfg.dropout,
                activation="gelu", normalize_before=False)
            self.encoder = nn.TransformerEncoder(layer, cfg.num_layers)
            self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    @staticmethod
    def _extend_mask(attention_mask):
        """A ``[B, S]`` 1/0 keep-mask -> additive f32 ``[B, 1, 1, S]``
        (``(m - 1) * 1e9``); a bool mask (any rank) and a mask of another
        rank pass through (the encoder turns a bool keep-mask additive)."""
        if attention_mask is None:
            return None
        m = attention_mask
        if m.dim() == 2:
            m = m[:, None, None, :]
            if m.dtype != torch.bool:
                return (m.float() - 1.0) * 1e9
        return m

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None, position_ids=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(h, src_mask=self._extend_mask(attention_mask))
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertForPretraining(nn.Layer):
    """MLM and NSP heads."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        with default_place(device):
            self.bert = BertModel(cfg)
            self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
            self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                         epsilon=cfg.layer_norm_eps)
            self.mlm_decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)
            self.nsp = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        return self.mlm_decoder(h), self.nsp(pooled)

    def loss(self, mlm_logits, nsp_logits, masked_labels, nsp_labels,
             ignore_index=-100):
        """MLM cross-entropy over the labelled positions (``ignore_index``
        elsewhere) plus the NSP cross-entropy, each a mean in f32."""
        dev = mlm_logits.device
        masked_labels = torch.as_tensor(masked_labels, device=dev)
        nsp_labels = torch.as_tensor(nsp_labels, device=dev)
        mlm = F.cross_entropy(
            mlm_logits.reshape(-1, mlm_logits.shape[-1]),
            masked_labels.reshape(-1), ignore_index=ignore_index)
        nsp = F.cross_entropy(nsp_logits, nsp_labels)
        return mlm + nsp


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig, num_classes=2, *, device=None):
        super().__init__()
        with default_place(device):
            self.bert = BertModel(cfg)
            self.dropout = nn.Dropout(cfg.dropout)
            self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 64)
    kw.setdefault("dropout", 0.0)
    return BertConfig(**kw)
