"""BERT-base: port of paddle_tpu/models/bert.py (BASELINE config 3, the
PaddleNLP BERT fine-tune; reference anchor test/dygraph_to_static/
test_bert.py). Its attention is ``nn.MultiHeadAttention``: with no mask
and a sequence length that is a multiple of 128 it runs the flash
kernels (``nn.functional.attention.flash_route``)."""
from __future__ import annotations

import dataclasses

from .. import nn


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        from ..ops.creation import arange, zeros_like
        S = input_ids.shape[1]
        pos = arange(S, dtype="int32")
        if token_type_ids is None:
            token_type_ids = zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = nn.Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class Bert(nn.Layer):
    def __init__(self, cfg: BertConfig | None = None, **kw):
        super().__init__()
        cfg = cfg or BertConfig(**kw)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0, layer_norm_eps=1e-12)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [B,S] 1/0 mask → additive [B,1,1,S]
            from ..ops import manipulation as M
            m = M.cast(attention_mask, "float32")
            mask = (m - 1.0) * 1e9
            mask = M.reshape(mask, [mask.shape[0], 1, 1, mask.shape[1]])
        else:
            mask = None
        seq = self.encoder(x, mask)
        pooled = self.pooler(seq)
        return seq, pooled


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig | None = None, num_classes=2, **kw):
        super().__init__()
        self.bert = Bert(cfg, **kw)
        c = self.bert.cfg
        self.dropout = nn.Dropout(c.hidden_dropout_prob)
        self.classifier = nn.Linear(c.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForPretraining(nn.Layer):
    def __init__(self, cfg: BertConfig | None = None, **kw):
        super().__init__()
        self.bert = Bert(cfg, **kw)
        c = self.bert.cfg
        self.mlm_transform = nn.Linear(c.hidden_size, c.hidden_size)
        self.mlm_norm = nn.LayerNorm(c.hidden_size, epsilon=1e-12)
        self.nsp = nn.Linear(c.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        from ..nn import functional as F
        from ..ops.linalg import matmul
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        mlm_logits = matmul(h, self.bert.embeddings.word_embeddings.weight,
                            transpose_y=True)
        nsp_logits = self.nsp(pooled)
        return mlm_logits, nsp_logits
