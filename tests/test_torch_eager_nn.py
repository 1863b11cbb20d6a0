"""The port's nn (Layer, initializers, layers, functionals, clipping) against
the reference's: each layer with the reference's weights loaded by paddle's
keys, outputs and parameter gradients to 1e-5; initializers bitwise under
seed; attention routed to the flash path by the reference's shape rule."""
import numpy as np
import pytest
import torch

from torch_eager_ref import (P, T, assert_close, load_reference_state, pair,
                             seed_both, to_np)

TOL = 1e-5
_RNG = np.random.default_rng(23)
X2 = _RNG.standard_normal((4, 6)).astype(np.float32)
X4 = _RNG.standard_normal((2, 3, 9, 9)).astype(np.float32)
X3 = _RNG.standard_normal((2, 5, 8)).astype(np.float32)
XA = _RNG.standard_normal((2, 128, 16)).astype(np.float32)
IDS = _RNG.integers(0, 10, (2, 5)).astype(np.int64)
LAB = _RNG.integers(0, 6, (4,)).astype(np.int64)
SOFT = np.abs(_RNG.standard_normal((4, 6))).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)


def _mask(B, H, S):
    m = np.zeros((B, H, S, S), np.float32)
    m[..., :, S // 2:] = -1e9
    return m


def _mp(M):
    """The package's fleet.meta_parallel module."""
    import importlib
    return importlib.import_module(
        M.__name__ + ".distributed.fleet.meta_parallel")


# (id, build(module), inputs, call(layer, *tensors))
LAYERS = [
    ("Linear", lambda M: M.nn.Linear(6, 3), (X2,), None),
    ("Linear_no_bias", lambda M: M.nn.Linear(6, 3, bias_attr=False), (X2,),
     None),
    ("Conv2D", lambda M: M.nn.Conv2D(3, 4, 3, stride=2, padding=1), (X4,),
     None),
    ("Conv2D_groups_dilation", lambda M: M.nn.Conv2D(
        3, 6, 3, padding=[1, 2], dilation=2, groups=3), (X4,), None),
    ("Conv2DTranspose", lambda M: M.nn.Conv2DTranspose(
        3, 2, 3, stride=2, padding=1), (X4,), None),
    ("Conv1D", lambda M: M.nn.Conv1D(5, 4, 3, padding=1), (X3,), None),
    ("MaxPool2D", lambda M: M.nn.MaxPool2D(2, 2), (X4,), None),
    ("MaxPool2D_ceil_pad", lambda M: M.nn.MaxPool2D(3, 2, padding=1,
                                                    ceil_mode=True), (X4,),
     None),
    ("AvgPool2D_exclusive_pad", lambda M: M.nn.AvgPool2D(3, 2, padding=1),
     (X4,), None),
    ("AdaptiveAvgPool2D", lambda M: M.nn.AdaptiveAvgPool2D(4), (X4,), None),
    ("LayerNorm", lambda M: M.nn.LayerNorm(8), (X3,), None),
    ("BatchNorm2D_train", lambda M: M.nn.BatchNorm2D(3), (X4,), None),
    ("GroupNorm", lambda M: M.nn.GroupNorm(1, 3), (X4,), None),
    ("InstanceNorm2D", lambda M: M.nn.InstanceNorm2D(3), (X4,), None),
    ("Embedding", lambda M: M.nn.Embedding(10, 4, padding_idx=0), (IDS,),
     None),
    ("Flatten", lambda M: M.nn.Flatten(), (X4,), None),
    ("Identity", lambda M: M.nn.Identity(), (X2,), None),
    ("activations", lambda M: M.nn.Sequential(
        M.nn.Linear(6, 6), M.nn.GELU(), M.nn.Linear(6, 6), M.nn.Tanh(),
        M.nn.Linear(6, 6), M.nn.LeakyReLU(0.1), M.nn.Hardswish(),
        M.nn.Sigmoid(), M.nn.Softmax(), M.nn.ReLU6(), M.nn.ELU(),
        M.nn.Softplus(), M.nn.SELU()), (X2,), None),
    ("GELU_tanh", lambda M: M.nn.Sequential(M.nn.Linear(6, 6),
                                            M.nn.GELU(approximate=True)),
     (X2,), None),
    ("MultiHeadAttention", lambda M: M.nn.MultiHeadAttention(16, 4), (XA,),
     None),
    ("MultiHeadAttention_mask", lambda M: M.nn.MultiHeadAttention(16, 4),
     (XA, _mask(2, 4, 128)), lambda layer, x, m: layer(x, x, x, m)),
    ("TransformerEncoderLayer", lambda M: M.nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0), (XA,), None),
    ("TransformerEncoder_pre_norm", lambda M: M.nn.TransformerEncoder(
        M.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                     normalize_before=True), 2), (XA,),
     None),
    ("ColumnRowParallelLinear", lambda M: M.nn.Sequential(
        _mp(M).ColumnParallelLinear(6, 8, gather_output=False),
        _mp(M).RowParallelLinear(8, 5, input_is_parallel=True)), (X2,),
     None),
    ("VocabParallelEmbedding", lambda M: _mp(M).VocabParallelEmbedding(
        10, 4), (IDS,), None),
    ("TransformerDecoderLayer", lambda M: M.nn.TransformerDecoderLayer(
        16, 4, 32, dropout=0.0), (XA, XA[:, :64]),
     lambda layer, tgt, mem: layer(tgt, mem)),
]


@pytest.mark.parametrize("name,build,inputs,call", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_with_reference_state(name, build, inputs, call):
    seed_both(5)
    ref, port = build(P), build(T)
    load_reference_state(port, ref)
    call = call or (lambda layer, *xs: layer(*xs))
    # float inputs take gradients, ids and the additive mask do not
    xr, xt = zip(*[pair(x, stop_gradient=x.dtype != np.float32
                        or x.shape == (2, 4, 128, 128))
                   for x in inputs])
    out_r, out_t = call(ref, *xr), call(port, *xt)
    assert_close(out_r, out_t, TOL, name)
    if not any(not p.stop_gradient for p in ref.parameters()) \
            and all(x.stop_gradient for x in xr):
        return
    w = np.cos(np.arange(out_r.size, dtype=np.float32)).reshape(
        to_np(out_r).shape)
    wr, wt = pair(w)
    P.sum(out_r * wr).backward()
    T.sum(out_t * wt).backward()
    for (k, pr), (k2, pt) in zip(ref.named_parameters(),
                                 port.named_parameters()):
        assert k == k2
        if pr.grad is not None:
            assert_close(pr.grad, pt.grad, TOL, f"{name} grad {k}")
    for a, b in zip(xr, xt):
        if not a.stop_gradient:
            assert_close(a.grad, b.grad, TOL, f"{name} input grad")
    # buffers (BatchNorm's running statistics) move alike
    for (k, a), (_, b) in zip(ref.named_buffers(), port.named_buffers()):
        assert_close(a, b, TOL, f"{name} buffer {k}")


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_is_the_reference_composite(causal):
    """With an additive mask both packages run their one plain composite,
    the mask added to the f32 scores before the causal fill."""
    q_np = XA.reshape(2, 128, 4, 4)
    (qr, qt), (mr, mt) = pair(q_np, False), pair(_mask(2, 4, 128))
    outs = [M.nn.functional.scaled_dot_product_attention(
        q, q * 0.5, q, attn_mask=m, is_causal=causal)
        for M, q, m in ((P, qr, mr), (T, qt, mt))]
    assert_close(outs[0], outs[1], TOL)
    for o in outs:
        (o * o).sum().backward()
    assert_close(qr.grad, qt.grad, TOL)


def test_flags_are_the_ported_ones():
    """Only the flags the port acts on exist: an unknown one (the
    reference's NaN/Inf check, not ported) raises, as in set_flags."""
    from paddle_tpu_torch.framework import flags
    assert flags.get_flags("FLAGS_use_pallas_kernels") == {
        "FLAGS_use_pallas_kernels": True}
    for name in ("FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level"):
        with pytest.raises(KeyError):
            flags.set_flags({name: True})


def test_attention_routes_by_the_reference_shape_rule():
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.nn.functional import attention
    F = T.nn.functional
    attention.routes.update(dict.fromkeys(attention.routes, 0))
    q = T.to_tensor(XA.reshape(2, 128, 4, 4))
    F.scaled_dot_product_attention(q, q, q)
    F.scaled_dot_product_attention(q[:, :100], q[:, :100], q[:, :100])
    F.scaled_dot_product_attention(q, q, q, attn_mask=T.to_tensor(
        _mask(2, 4, 128)))
    flags.set_flags({"FLAGS_use_pallas_kernels": False})
    try:
        F.scaled_dot_product_attention(q, q, q, is_causal=True)
    finally:
        flags.set_flags({"FLAGS_use_pallas_kernels": True})
    assert attention.routes == {"kernel": 1, "plain_shape": 1,
                                "plain_mask": 1, "plain_flag": 1}
    # every route computes the same attention as the reference
    qr = P.to_tensor(XA.reshape(2, 128, 4, 4))
    for causal in (False, True):
        assert_close(P.nn.functional.scaled_dot_product_attention(
            qr, qr, qr, is_causal=causal),
            F.scaled_dot_product_attention(q, q, q, is_causal=causal), TOL)


LOSSES = [
    ("ce", lambda M, x, y: M.nn.CrossEntropyLoss()(x, y), (X2, LAB)),
    ("ce_ignore_sum", lambda M, x, y: M.nn.functional.cross_entropy(
        x, y, ignore_index=2, reduction="sum"), (X2, LAB)),
    ("ce_soft_label", lambda M, x, s: M.nn.functional.cross_entropy(
        x, s, soft_label=True), (X2, SOFT)),
    ("ce_axis0_none", lambda M, x, y: M.nn.functional.cross_entropy(
        M.transpose(x, [1, 0]), y, axis=0, reduction="none"), (X2, LAB)),
    ("ce_no_softmax", lambda M, s, y: M.nn.functional.cross_entropy(
        s, y, use_softmax=False), (SOFT, LAB)),
    ("ce_label_smoothing", lambda M, x, y: M.nn.functional.cross_entropy(
        x, y, label_smoothing=0.1), (X2, LAB)),
    ("softmax_with_ce", lambda M, x, y: M.nn.functional
     .softmax_with_cross_entropy(x, M.unsqueeze(y, -1)), (X2, LAB)),
    ("nll", lambda M, x, y: M.nn.NLLLoss()(
        M.nn.functional.log_softmax(x), y), (X2, LAB)),
    ("mse_l1_smooth", lambda M, x, s: M.nn.MSELoss()(x, s)
     + M.nn.L1Loss()(x, s) + M.nn.SmoothL1Loss()(x, s), (X2, SOFT)),
    ("bce_logits", lambda M, x, s: M.nn.BCEWithLogitsLoss()(x, s),
     (X2, SOFT)),
    ("bce", lambda M, x, s: M.nn.BCELoss()(M.nn.functional.sigmoid(x), s),
     (X2, SOFT)),
    ("kl_div", lambda M, x, s: M.nn.KLDivLoss()(
        M.nn.functional.log_softmax(x), s), (X2, SOFT)),
    ("huber", lambda M, x, s: M.nn.HuberLoss(delta=0.5)(x, s), (X2, SOFT)),
]


@pytest.mark.parametrize("name,fn,inputs", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_and_its_gradient(name, fn, inputs):
    xr, xt = pair(inputs[0], stop_gradient=False)
    yr, yt = pair(inputs[1])
    lr, lt = fn(P, xr, yr), fn(T, xt, yt)
    assert_close(lr, lt, TOL, name)
    P.sum(lr).backward()
    T.sum(lt).backward()
    assert_close(xr.grad, xt.grad, TOL, f"{name} grad")


INITS = [
    ("Normal", lambda M: M.nn.initializer.Normal(0.5, 2.0)),
    ("Uniform", lambda M: M.nn.initializer.Uniform(-0.3, 0.7)),
    ("XavierNormal", lambda M: M.nn.initializer.XavierNormal()),
    ("XavierUniform", lambda M: M.nn.initializer.XavierUniform()),
    ("KaimingNormal", lambda M: M.nn.initializer.KaimingNormal()),
    ("KaimingUniform", lambda M: M.nn.initializer.KaimingUniform()),
    ("Constant", lambda M: M.nn.initializer.Constant(0.25)),
]


@pytest.mark.parametrize("name,make", INITS, ids=[c[0] for c in INITS])
def test_initializers_bitwise(name, make):
    seed_both(3)
    r = make(P)((5, 7), "float32")
    t = make(T)((5, 7), "float32")
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_truncated_normal_within_an_ulp_of_its_bounds():
    """The bounds' erf are formed in float64 (XLA's f32 erf may differ in
    the last bit), so a draw equals the reference's to a few ulp."""
    seed_both(3)
    r = np.asarray(P.nn.initializer.TruncatedNormal(0.0, 0.02)((64, 64),
                                                              "float32"))
    t = T.nn.initializer.TruncatedNormal(0.0, 0.02)((64, 64),
                                                    "float32").numpy()
    np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-9)
    assert np.abs(t).max() <= 0.04


@pytest.mark.parametrize("build", [
    lambda M: M.nn.Linear(7, 5), lambda M: M.nn.Embedding(11, 6),
    lambda M: M.nn.Conv2D(3, 4, 3), lambda M: M.models.LeNet()],
    ids=["Linear", "Embedding", "Conv2D", "LeNet"])
def test_layer_init_bitwise_under_seed(build):
    seed_both(0)
    ref, port = build(P), build(T)
    rs, ts = ref.state_dict(), port.state_dict()
    assert list(rs) == list(ts)
    for k in rs:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(rs[k].numpy()),
                                      err_msg=k)


def test_layer_api_is_paddles_and_registers_with_torch():
    class Net(T.nn.Layer):
        def __init__(self):
            super().__init__()
            self.body = T.nn.Sequential(T.nn.Linear(4, 4), T.nn.ReLU())
            self.heads = T.nn.LayerList([T.nn.Linear(4, 2)
                                         for _ in range(2)])
            self.extra = T.nn.ParameterList([self.create_parameter([3])])
            self.register_buffer("steps", T.zeros([1]))
            self.register_buffer("scratch", T.zeros([1]), persistable=False)

        def forward(self, x):
            h = self.body(x)
            return self.heads[0](h) + self.heads[1](h)

    net = Net()
    assert isinstance(net, torch.nn.Module)
    names = [k for k, _ in net.named_parameters()]
    assert names == ["body.0.weight", "body.0.bias", "heads.0.weight",
                     "heads.0.bias", "heads.1.weight", "heads.1.bias",
                     "extra.0"]
    assert isinstance(net.parameters(), list)
    assert [p._value for p in net.parameters()] == list(
        torch.nn.Module.parameters(net))
    assert list(net.state_dict()) == names + ["steps"]
    assert len(net.sublayers()) == 7
    net.eval()
    assert not any(l.training for l in net.sublayers(include_self=True))
    net.train()
    assert all(l.training for l in net.sublayers(include_self=True))
    seen = []
    pre = net.register_forward_pre_hook(lambda layer, inp: seen.append("pre"))
    post = net.register_forward_post_hook(
        lambda layer, inp, out: out * 0.0)
    out = net(T.to_tensor(X2[:, :4]))
    assert seen == ["pre"] and float(T.abs(out).sum()) == 0.0
    pre.remove()
    post.remove()
    state = {k: v.numpy() * 2 for k, v in net.state_dict().items()}
    missing, unexpected = net.set_state_dict(dict(state, bogus=np.ones(1)))
    assert missing == [] and unexpected == ["bogus"]
    np.testing.assert_array_equal(net.body[0].weight.numpy(),
                                  state["body.0.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"body.0.weight": np.ones((2, 2))})
    # a deep copy keeps torch's registry and paddle's on one object each
    import copy
    twin = copy.deepcopy(net)
    assert [p._value for p in twin.parameters()] == list(
        torch.nn.Module.parameters(twin))


def test_parallel_layers_raise_above_degree_one():
    from types import SimpleNamespace
    mp = _mp(T)
    group = SimpleNamespace(nranks=2)
    for build in (lambda: mp.ColumnParallelLinear(4, 4, mp_group=group),
                  lambda: mp.RowParallelLinear(4, 4, mp_group=group),
                  lambda: mp.VocabParallelEmbedding(8, 4, mp_group=group),
                  lambda: mp.ParallelCrossEntropy(mp_group=group)):
        with pytest.raises(NotImplementedError, match="degree 2"):
            build()
    assert_close(P.sum(_mp(P).ParallelCrossEntropy()(pair(X2)[0], pair(
        LAB[:, None])[0])), T.sum(mp.ParallelCrossEntropy()(
            pair(X2)[1], pair(LAB[:, None])[1])), TOL)


CLIPS = [
    ("global_norm", lambda M: M.nn.ClipGradByGlobalNorm(0.5)),
    ("norm", lambda M: M.nn.ClipGradByNorm(0.3)),
    ("value", lambda M: M.nn.ClipGradByValue(0.2)),
]


@pytest.mark.parametrize("name,make", CLIPS, ids=[c[0] for c in CLIPS])
def test_grad_clipping(name, make):
    res = {}
    for M in (P, T):
        seed_both(2)
        grads = [M.to_tensor(X2 * 3.0), M.to_tensor(X2[:2] * 0.1)]
        params = [M.nn.Linear(6, 4).weight, M.nn.Linear(6, 2).weight]
        res[M] = [to_np(g) for _, g in make(M)(list(zip(params, grads)))]
    for a, b in zip(res[P], res[T]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
