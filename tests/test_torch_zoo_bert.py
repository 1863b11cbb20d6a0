"""The port's BERT (``paddle_tpu_torch.models.bert``) against the
reference's at a 2-layer tiny width, from the same seeded weights: the
encoder's outputs, BertForSequenceClassification over 3 AdamW steps,
and BertForPretraining's heads
(tests/test_torch_zoo_bert_static.py holds TestBertE2E)."""
import numpy as np
import pytest

from torch_eager_ref import P, T, assert_close, train_parity, twins
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
IDS = np.random.default_rng(0).integers(0, 128, (4, 16))
TYPES = np.random.default_rng(1).integers(0, 2, (4, 16))


def _make(M, cls, **kw):
    from importlib import import_module
    mod = import_module(f"{M.__name__}.models.bert")
    return getattr(mod, cls)(mod.BertConfig(**{**TINY, **kw}))


def test_bert_encoder_equals_the_reference(monkeypatch):
    ref, port = twins(lambda: _make(P, "Bert"), lambda: _make(T, "Bert"),
                      monkeypatch, std=0.02)
    ref.eval()
    port.eval()
    mask = np.ones((4, 16), np.int64)
    mask[:, 12:] = 0
    for args in ((IDS,), (IDS, TYPES), (IDS, TYPES, mask)):
        r = ref(*[P.to_tensor(a) for a in args])
        t = port(*[T.to_tensor(a) for a in args])
        assert_close(r[0], t[0], 1e-5, "sequence output")
        assert_close(r[1], t[1], 1e-5, "pooled output")


def test_bert_classifier_finetunes_as_the_reference(monkeypatch):
    """Train mode with dropout 0 (the reference runs through its
    ``jit.to_static``, which draws its own masks; the masks' parity is
    held by tests/test_torch_eager_models.py and _tensor.py): 3 AdamW
    steps, logits within 1e-4, gradients within 1e-4 of their scale,
    losses within 1e-5."""
    def adamw(M, params, lr):
        return M.optimizer.AdamW(learning_rate=lr, parameters=params)
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ref, port = twins(
        lambda: P.jit.to_static(_make(P, "BertForSequenceClassification",
                                      **no_drop)),
        lambda: _make(T, "BertForSequenceClassification", **no_drop),
        monkeypatch, std=0.02)
    losses = train_parity(ref, port, (IDS, TYPES), np.array([0, 1, 1, 0]),
                          lr=5e-3, optimizer=adamw)
    assert losses[-1] < losses[0]


def test_bert_pretraining_heads_equal_the_reference(monkeypatch):
    ref, port = twins(lambda: _make(P, "BertForPretraining"),
                      lambda: _make(T, "BertForPretraining"),
                      monkeypatch, std=0.02)
    ref.eval()
    port.eval()
    r = ref(P.to_tensor(IDS))
    t = port(T.to_tensor(IDS))
    assert t[0].shape == [4, 16, 128] and t[1].shape == [4, 2]
    assert_close(r[0], t[0], 1e-5, "mlm logits")
    assert_close(r[1], t[1], 1e-5, "nsp logits")
