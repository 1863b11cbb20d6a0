"""The port's recurrent layers, sequence losses and beam search against the
reference's, on the CPU: every RNN layer with the reference's weights
carried across (outputs, final states and the gradients of inputs,
initial states and parameters to 1e-5), the seeded initializers drawing
the reference's RNN weights bitwise, the losses (rnnt_loss also against
a brute-force sum over alignments), gather_tree and dynamic_decode."""
import numpy as np
import pytest

from torch_eager_ref import (P, T, assert_close, load_reference_state,
                             numpy_weights, seed_both, to_np, zero_init)

TOL = 1e-5
_RNG = np.random.default_rng(31)
# one width everywhere (input = hidden = 4, B = 2, T = 3): the
# reference compiles each op once a shape
X = _RNG.standard_normal((2, 3, 4)).astype(np.float32)       # [B, T, in]
H0 = _RNG.standard_normal((4, 2, 4)).astype(np.float32)      # [L*D, B, H]
C0 = _RNG.standard_normal((4, 2, 4)).astype(np.float32)


def _tm(x):
    return np.ascontiguousarray(np.transpose(x, (1, 0, 2)))


def _states(*arrays):
    return lambda M: tuple(M.to_tensor(a, stop_gradient=False)
                           for a in arrays)


# (id, build(module), input, initial states(module) or None); between
# them every layer class, multi-layer, bidirectional, time_major, reverse,
# initial states, dropout and both SimpleRNN activations
LAYERS = [
    ("LSTM_2layer_bidirect_time_major_states", lambda M: M.nn.LSTM(
        4, 4, num_layers=2, direction="bidirectional", time_major=True),
     _tm(X), _states(H0, C0)),
    # dropout between the layers only, the masks drawn as the reference's
    ("LSTM_2layer_dropout", lambda M: M.nn.LSTM(4, 4, num_layers=2,
                                                dropout=0.5), X, None),
    ("GRU_2layer_bidirect_states", lambda M: M.nn.GRU(
        4, 4, num_layers=2, direction="bidirect"), X,
     lambda M: M.to_tensor(H0, stop_gradient=False)),
    ("SimpleRNN_relu_backward_states", lambda M: M.nn.SimpleRNN(
        4, 4, direction="backward", activation="relu"), X,
     lambda M: M.to_tensor(H0[:1], stop_gradient=False)),
    ("BiRNN_SimpleRNNCell_tanh_time_major", lambda M: M.nn.BiRNN(
        M.nn.SimpleRNNCell(4, 4), M.nn.SimpleRNNCell(4, 4),
        time_major=True), _tm(X), None),
    ("RNN_GRUCell_reverse", lambda M: M.nn.RNN(M.nn.GRUCell(4, 4),
                                               is_reverse=True), X, None),
]


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _run(M, layer, x, init):
    xi = M.to_tensor(x, stop_gradient=False)
    states = init(M) if init else None
    y, final = layer(xi, states)
    loss = M.sum(y * y)
    for s in _flat(final):
        loss = loss + M.sum(s * s * 0.5)
    loss.backward()
    grads = [xi.grad] + [s.grad for s in _flat(states)] \
        if states is not None else \
        [xi.grad]
    return ([to_np(y)] + [to_np(s) for s in _flat(final)],
            [to_np(g) for g in grads],
            {n: to_np(p.grad) for n, p in layer.named_parameters()})


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_rnn_layer_matches_reference(case, monkeypatch):
    """The first case's seeded draw gives both packages the same weights
    (checked bitwise); the others start from zeros (the reference compiles
    its draw once a shape) and take the same seeded numpy weights. The
    reference's weights are then carried across; outputs, final states
    and every gradient agree to 1e-5. The layers run in train mode
    (dropout masks from the same seed)."""
    _, build, x, init = case
    drawn = case is LAYERS[0]
    if not drawn:
        zero_init(monkeypatch)
    seed_both(11)
    ref, port = build(P), build(T)
    rs, ps = ref.state_dict(), port.state_dict()
    assert sorted(rs) == sorted(ps)
    if drawn:
        for k in rs:
            np.testing.assert_array_equal(to_np(ps[k]), to_np(rs[k]),
                                          err_msg=k)
    else:
        ref.set_state_dict(numpy_weights(port, 12, std=0.5))
    load_reference_state(port, ref)
    (ro, rg, rp), (to, tg, tp) = _run(P, ref, x, init), _run(T, port, x, init)
    assert [a.shape for a in ro] == [b.shape for b in to]
    for a, b in zip(ro + rg, to + tg):
        assert_close(a, b, TOL)
    assert rp.keys() == tp.keys()
    for k in rp:
        assert_close(rp[k], tp[k], TOL, k)


def _rnnt_bruteforce(logits, labels, T_, U):
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    paths = []

    def rec(t, u, acc):
        if t == T_ - 1 and u == U:
            paths.append(acc + logp[0, t, u, 0])
            return
        if u < U:
            rec(t, u + 1, acc + logp[0, t, u, labels[0, u]])
        if t < T_ - 1:
            rec(t + 1, u, acc + logp[0, t, u, 0])

    rec(0, 0, 0.0)
    return -np.logaddexp.reduce(paths)


def test_rnnt_loss_matches_bruteforce_and_reference():
    """The reference test's brute force over every alignment (B=1), then
    a ragged batch against the reference with its gradients."""
    B, T_, U, V = 1, 3, 2, 4
    logits = _RNG.standard_normal((B, T_, U + 1, V)).astype(np.float32)
    labels = np.asarray([[1, 2]], np.int64)
    got = float(T.nn.functional.rnnt_loss(
        T.to_tensor(logits), T.to_tensor(labels), T.to_tensor([T_]),
        T.to_tensor([U]), reduction="none").numpy()[0])
    assert abs(got - _rnnt_bruteforce(logits, labels, T_, U)) < 1e-4
    logits = _RNG.standard_normal((3, 4, 3, 5)).astype(np.float32)
    labels = np.asarray([[1, 2], [3, 0], [4, 4]], np.int64)
    out = {}
    for M in (P, T):
        x = M.to_tensor(logits, stop_gradient=False)
        loss = M.nn.RNNTLoss(blank=0)(
            x, M.to_tensor(labels), M.to_tensor(np.asarray([4, 3, 4])),
            M.to_tensor(np.asarray([2, 1, 2])))
        loss.backward()
        out[M] = (to_np(loss), to_np(x.grad))
    for a, b in zip(out[P], out[T]):
        assert_close(a, b, TOL)


def test_ctc_loss_matches_reference():
    """F.ctc_loss and CTCLoss on ragged lengths, each reduction, with the
    gradient of the scores."""
    scores = _RNG.standard_normal((6, 3, 5)).astype(np.float32)
    labels = np.asarray([[1, 2, 2], [3, 1, 0], [4, 0, 0]], np.int32)
    ilen, llen = np.asarray([6, 5, 4]), np.asarray([3, 2, 1])
    out = {}
    for M in (P, T):
        F = M.nn.functional
        x = M.to_tensor(scores, stop_gradient=False)
        args = (M.to_tensor(labels), M.to_tensor(ilen), M.to_tensor(llen))
        none = F.ctc_loss(F.log_softmax(x), *args, reduction="none")
        total = F.ctc_loss(F.log_softmax(x), *args, reduction="sum")
        mean = M.nn.CTCLoss()(F.log_softmax(x), *args)
        mean.backward()
        out[M] = [to_np(none), to_np(total), to_np(mean), to_np(x.grad)]
    for a, b in zip(out[P], out[T]):
        assert_close(a, b, TOL)


def test_hsigmoid_loss_five_classes_matches_reference():
    """hsigmoid_loss with 5 classes (a non-power-of-two tree) and the
    HSigmoidLoss layer, whose seeded draw is the reference's; values and
    the gradients of input, weight and bias."""
    a = _RNG.standard_normal((5, 6)).astype(np.float32)
    w = (_RNG.standard_normal((4, 6)) * 0.1).astype(np.float32)
    b = (_RNG.standard_normal((4, 1)) * 0.1).astype(np.float32)
    lab = np.arange(5).astype(np.int64)
    out = {}
    for M in (P, T):
        x, wt, bt = (M.to_tensor(v, stop_gradient=False) for v in (a, w, b))
        loss = M.nn.functional.hsigmoid_loss(x, M.to_tensor(lab), 5, wt,
                                             bias=bt)
        M.sum(loss).backward()
        seed_both(2)
        layer = M.nn.HSigmoidLoss(6, 5)
        lv = layer(M.to_tensor(a), M.to_tensor(lab))
        out[M] = [to_np(loss), to_np(x.grad), to_np(wt.grad), to_np(bt.grad),
                  to_np(lv), sorted(layer.state_dict())]
    assert out[T][5] == out[P][5] == ["p0", "p1"]
    for a_, b_ in zip(out[P][:5], out[T][:5]):
        assert_close(a_, b_, TOL)


@pytest.mark.parametrize("variant", ["default", "swap", "distance_fn"])
def test_triplet_margin_with_distance_loss_matches_reference(variant):
    a, p, n = (_RNG.standard_normal((4, 8)).astype(np.float32)
               for _ in range(3))
    out = {}
    for M in (P, T):
        kw = {"swap": True} if variant == "swap" else {}
        if variant == "distance_fn":
            kw["distance_function"] = lambda u, v: ((u - v) ** 2).sum(-1)
        ta = M.to_tensor(a, stop_gradient=False)
        loss = M.nn.TripletMarginWithDistanceLoss(margin=2.0, **kw)(
            ta, M.to_tensor(p), M.to_tensor(n))
        loss.backward()
        out[M] = (to_np(loss), to_np(ta.grad))
    for x, y in zip(out[P], out[T]):
        assert_close(x, y, TOL)


def test_gather_tree_matches_reference():
    ids = _RNG.integers(0, 9, (5, 2, 3)).astype(np.int64)
    parents = _RNG.integers(0, 3, (5, 2, 3)).astype(np.int64)
    got = [to_np(M.nn.functional.gather_tree(M.to_tensor(ids),
                                             M.to_tensor(parents)))
           for M in (P, T)]
    np.testing.assert_array_equal(got[1], got[0])


def test_dynamic_decode_matches_reference():
    """Beam search over a tiny LSTMCell with an embedding and an output
    projection, the reference's weights carried across: the same ids
    [B, T, beam], best-first, and the same lengths."""
    res = {}
    layers = {}
    for M in (P, T):
        seed_both(9)
        layers[M] = (M.nn.LSTMCell(8, 8), M.nn.Embedding(12, 8),
                     M.nn.Linear(8, 12))
    for r, t in zip(layers[P], layers[T]):
        load_reference_state(t, r)
    for M in (P, T):
        cell, emb, out = layers[M]
        dec = M.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                     beam_size=3, embedding_fn=emb,
                                     output_fn=out)
        h0 = M.to_tensor(_RNG.standard_normal((2, 8)).astype(np.float32)
                         if M is P else res["h0"])
        res["h0"] = to_np(h0)
        ids, lens = M.nn.dynamic_decode(dec, inits=(h0, h0), max_step_num=4)
        res[M] = (to_np(ids), to_np(lens))
    assert res[T][0].shape == res[P][0].shape and res[T][0].shape[0] == 2 \
        and res[T][0].shape[2] == 3
    np.testing.assert_array_equal(res[T][0], res[P][0])
    np.testing.assert_array_equal(res[T][1], res[P][1])
