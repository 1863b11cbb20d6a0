"""tests/test_static_nn_bert.py's TestBertE2E on the port's BERT: the same
model gives the same outputs eagerly and through ``jit.to_static``
(``backend="aot_eager"``), and fine-tunes compiled (its eager parity with
the reference is tests/test_torch_zoo_bert.py's)."""
import numpy as np
import pytest

from test_torch_zoo_bert import IDS, _make
from torch_eager_ref import P, T, twins
from torch_eager_ref import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def test_bert_dygraph_to_static_parity_and_finetune(monkeypatch):
    """TestBertE2E: eval outputs equal eagerly and compiled (within the
    reference test's 2e-4 / 2e-5); then 8 compiled fine-tune steps with a
    classification head, whose loss falls, as the reference's does."""
    _, port = twins(lambda: _make(P, "Bert"), lambda: _make(T, "Bert"),
                    monkeypatch, std=0.02)
    port.eval()
    ids = T.to_tensor(IDS)
    seq_eager, pooled_eager = port(ids)
    static_model = T.jit.to_static(port, backend="aot_eager")
    seq_jit, pooled_jit = static_model(ids)
    np.testing.assert_allclose(seq_jit.numpy(), seq_eager.numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pooled_jit.numpy(), pooled_eager.numpy(),
                               rtol=2e-4, atol=2e-5)

    T.seed(0)
    head = T.nn.Linear(32, 2)
    port.train()
    opt = T.optimizer.AdamW(learning_rate=5e-3,
                            parameters=port.parameters() + head.parameters())
    labels = T.to_tensor(np.array([0, 1, 1, 0]))
    losses = []
    for _ in range(8):
        _, pooled = static_model(ids)
        loss = T.nn.functional.cross_entropy(head(pooled), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert losses[-1] < losses[0]
    # eval and train: one graph each
    assert port._static_function.compiles == 2
