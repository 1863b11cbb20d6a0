"""The port's eager Tensor and ops against the reference's (paddle_tpu):
the same numpy inputs through both packages, forward values and dtypes
equal to 1e-6, gradients to 1e-6, and paddle's autograd semantics
(stop_gradient, accumulation, clear_grad, hooks, retain_graph, in-place
rules, PyLayer, paddle.grad) and its seeded random ops."""
import numpy as np
import pytest

from torch_eager_ref import P, T, assert_close, pair, seed_both, to_np

TOL = 1e-6
_RNG = np.random.default_rng(17)
# a few shapes reused across cases: the reference compiles once a shape
A34 = _RNG.standard_normal((3, 4)).astype(np.float32)
B34 = _RNG.standard_normal((3, 4)).astype(np.float32)
C45 = _RNG.standard_normal((4, 5)).astype(np.float32)
D234 = _RNG.standard_normal((2, 3, 4)).astype(np.float32)
E245 = _RNG.standard_normal((2, 4, 5)).astype(np.float32)
POS34 = (np.abs(A34) + 0.5).astype(np.float32)
I34 = _RNG.integers(-9, 10, (3, 4)).astype(np.int64)
J34 = _RNG.integers(1, 7, (3, 4)).astype(np.int64)
IDX = np.array([2, 0, 1, 2], np.int64)
F314 = _RNG.standard_normal((3, 1, 4)).astype(np.float32)
SQ = (_RNG.standard_normal((4, 4)) + 3 * np.eye(4)).astype(np.float32)
SEQ = np.array([1.0, 3.0, 5.0, 7.0], np.float32)

# (id, f(module, *tensors), inputs, differentiable inputs)
CASES = [
    ("add", lambda M, a, b: a + b, (A34, B34), True),
    ("sub_rsub", lambda M, a, b: 2.0 - a - b, (A34, B34), True),
    ("mul", lambda M, a, b: a * b * 3.0, (A34, B34), True),
    ("div", lambda M, a, b: a / (M.abs(b) + 1.0), (A34, B34), True),
    ("pow", lambda M, a: a ** 3, (A34,), True),
    ("maximum", lambda M, a, b: M.maximum(a, b), (A34, B34), True),
    ("minimum", lambda M, a, b: M.minimum(a, b), (A34, B34), True),
    ("exp_log", lambda M, a: M.log(M.exp(a) + a * a + 1.0), (A34,), True),
    ("sqrt_rsqrt", lambda M, a: M.sqrt(a) + M.rsqrt(a), (POS34,), True),
    ("tanh_sigmoid", lambda M, a: M.tanh(a) * M.sigmoid(a), (A34,), True),
    ("abs_neg_square", lambda M, a: M.abs(-a) + M.square(a), (A34,), True),
    ("sum_axis", lambda M, a: M.sum(a, axis=1), (D234,), True),
    ("mean_keepdim", lambda M, a: M.mean(a, axis=[0, 2], keepdim=True),
     (D234,), True),
    ("max_axis", lambda M, a: M.max(a, axis=1), (A34,), True),
    ("prod", lambda M, a: M.prod(a, axis=0), (A34,), True),
    ("logsumexp", lambda M, a: M.logsumexp(a, axis=-1), (A34,), True),
    ("cumsum", lambda M, a: M.cumsum(a, axis=1), (A34,), True),
    ("std_var", lambda M, a: M.std(a, axis=1) + M.var(a), (A34,), True),
    ("matmul", lambda M, a, c: M.matmul(a, c), (A34, C45), True),
    ("matmul_transpose_y", lambda M, a, b: M.matmul(a, b, transpose_y=True),
     (A34, B34), True),
    ("matmul_transpose_x", lambda M, a, b: M.matmul(a, b, transpose_x=True),
     (A34, B34), True),
    ("bmm", lambda M, d, e: M.bmm(d, e), (D234, E245), True),
    ("reshape_transpose",
     lambda M, d: M.transpose(M.reshape(d, [4, 6]), [1, 0]), (D234,), True),
    ("concat_split", lambda M, a, b: M.split(M.concat([a, b], axis=1),
                                             [3, -1], axis=1)[1], (A34, B34),
     True),
    ("stack_unsqueeze", lambda M, a, b: M.unsqueeze(M.stack([a, b]), -1),
     (A34, B34), True),
    ("squeeze_flatten", lambda M, d: M.flatten(M.squeeze(
        M.unsqueeze(d, 0), 0), 1), (D234,), True),
    ("gather", lambda M, a, i: M.gather(a, i, axis=1), (A34, IDX), True),
    ("index_select", lambda M, a, i: M.index_select(a, i[:2], axis=0),
     (A34, IDX), True),
    ("where", lambda M, a, b: M.where(a > b, a, b), (A34, B34), True),
    ("clip_scale", lambda M, a: M.scale(M.clip(a, -0.5, 0.5), 2.0, 1.0),
     (A34,), True),
    ("tile_expand", lambda M, a: M.tile(a, [2, 1]) + M.expand(
        a[:1], [6, 4]), (A34,), True),
    ("flip_roll", lambda M, a: M.flip(a, [1]) + M.roll(a, 1, 0), (A34,),
     True),
    ("pad", lambda M, d: M.nn.functional.pad(
        M.unsqueeze(d, 0), [1, 2, 0, 1]), (D234,), True),
    ("getitem_slices", lambda M, d: d[1:, ::2, -1], (D234,), True),
    ("getitem_tensor_index", lambda M, a, i: a[i], (A34, IDX[:3]), True),
    ("masked_fill", lambda M, a, b: M.masked_fill(a, a > b, 0.5), (A34, B34),
     True),
    ("methods", lambda M, a: a.sum(1).mean() * a.max() + a.t().abs().sum(),
     (A34,), True),
    ("broadcast", lambda M, f, a: f + a * f, (F314, A34), True),
    ("einsum", lambda M, a, c: M.einsum("ij,jk->ik", a, c), (A34, C45),
     True),
    ("scatter", lambda M, a, b: M.scatter(a, M.to_tensor([2, 0]), b[:2]),
     (A34, B34), True),
    ("cummax", lambda M, a: M.cummax(a, axis=1)[0], (A34,), True),
    ("inverse_det", lambda M, q: M.inverse(q) * M.linalg.det(q), (SQ,),
     True),
    ("searchsorted", lambda M, s, a: M.searchsorted(s, a), (SEQ, A34[0]),
     False),
    ("nonzero_unique", lambda M, i: M.unique(i) + M.sum(M.nonzero(i)),
     (I34,), False),
    ("allclose", lambda M, a, b: M.allclose(a, a + b * 1e-9), (A34, B34),
     False),
    ("argmax", lambda M, a: M.argmax(a, axis=1), (A34,), False),
    ("sort_topk", lambda M, a: M.sort(a, axis=1) + M.topk(a, 4)[0], (A34,),
     True),
    ("compare", lambda M, a, b: (a > b).astype("float32") + (a == a)
     .astype("float32"), (A34, B34), False),
    ("cast_int", lambda M, a: (a * 4.0).astype("int32"), (A34,), False),
    ("int_divide_is_float", lambda M, i, j: i / j, (I34, J34), False),
    ("int_floor_divide_mod", lambda M, i, j: i // j + i % j, (I34, J34),
     False),
    ("int_sum_stays_int32", lambda M, i: M.sum(i, axis=0), (I34,), False),
    ("int_mean_is_float", lambda M, i: M.mean(i), (I34,), False),
]


@pytest.mark.parametrize("name,fn,inputs,diff", CASES,
                         ids=[c[0] for c in CASES])
def test_op_forward_and_grad(name, fn, inputs, diff):
    ref, port = [], []
    for x in inputs:
        grad = diff and x.dtype == np.float32 and x is not IDX
        r, t = pair(x, stop_gradient=not grad)
        ref.append(r)
        port.append(t)
    out_r, out_t = fn(P, *ref), fn(T, *port)
    assert str(out_t.dtype) == str(out_r.dtype), name
    assert out_t.stop_gradient == out_r.stop_gradient, name
    assert_close(out_r, out_t, TOL, name)
    if not diff:
        return
    w = np.linspace(-1, 1, out_r.size, dtype=np.float32).reshape(
        to_np(out_r).shape)
    wr, wt = pair(w)
    P.sum(out_r * wr).backward()
    T.sum(out_t * wt).backward()
    for r, t in zip(ref, port):
        if r.stop_gradient:
            continue
        # an input the output depends on only through a mask gets none
        assert (t.grad is None) == (r.grad is None), name
        if r.grad is not None:
            assert_close(r.grad, t.grad, TOL, f"{name} grad")


@pytest.mark.parametrize("data,dtype", [
    ([1, 2], None), (np.float64(1.5), None), ([[1.0, 2.0]], None),
    (np.arange(6, dtype=np.int64), None), ([1.0], "bfloat16"),
    ([True, False], None), ([1, 2], "float16"), (np.ones(3), "int64"),
    ([1.0, 2.5], "float8_e4m3fn")],
    ids=["ints", "f64_scalar", "floats", "int64_array", "bf16", "bool",
         "f16", "int64_dtype", "f8"])
def test_to_tensor_dtypes(data, dtype):
    r = P.to_tensor(data, dtype=dtype)
    t = T.to_tensor(data, dtype=dtype)
    assert str(t.dtype) == str(r.dtype)
    assert t.numpy().dtype == r.numpy().dtype
    assert t.shape == r.shape and t.stop_gradient
    np.testing.assert_array_equal(to_np(t), to_np(r))


def test_stop_gradient_propagation_and_leaves():
    for M in (P, T):
        x = M.to_tensor(A34, stop_gradient=False)
        c = M.to_tensor(B34)
        assert c.stop_gradient and not x.stop_gradient
        assert (c * 2.0).stop_gradient
        assert not (x * c).stop_gradient
        assert x.detach().stop_gradient
        assert not x.clone().stop_gradient
        with M.no_grad():
            assert (x * 2.0).stop_gradient
        p = M.nn.Linear(4, 2).weight
        assert not p.stop_gradient
        assert (M.argmax(x, axis=1)).stop_gradient is False


def _twice(M, retain):
    x = M.to_tensor(A34, stop_gradient=False)
    y = M.sum(x * x)
    y.backward(retain_graph=retain)
    first = to_np(x.grad).copy()
    y.backward()
    return first, to_np(x.grad)


@pytest.mark.parametrize("retain", [False, True])
def test_backward_twice_matches_retain_graph(retain):
    """Without retain_graph the first backward consumes the graph: a
    second one changes no gradient (and does not raise). With it, the
    gradients accumulate."""
    (r1, r2), (t1, t2) = _twice(P, retain), _twice(T, retain)
    np.testing.assert_allclose(t1, r1, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t2, r2, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t2, 2 * t1 if retain else t1, rtol=TOL)


def _after_consumed(M, kind):
    """``h`` feeds a backward that consumes its producer; a second backward
    then runs from a new output built on ``h``."""
    x = M.to_tensor(A34, stop_gradient=False)
    h = x * x if kind == "saved" else x + 1.0
    M.sum(h * 2.0).backward()
    first = to_np(x.grad).copy()
    y = M.sum(h * 3.0 + x) if kind == "mixed" else M.sum(h * 3.0)
    y.backward()
    return h.is_leaf, first, to_np(x.grad), to_np(h.grad)


@pytest.mark.parametrize("kind", ["saved", "no_saved", "mixed"])
def test_backward_from_a_new_root_on_a_consumed_graph(kind):
    """The first backward consumes every node it ran (the reference drops
    them from its tape): ``h`` becomes a leaf, and a second backward from
    a new output on ``h`` fills ``h.grad`` and reaches ``x`` only by paths
    that avoid the consumed nodes. ``no_saved``: nodes that saved no
    tensor, which torch alone would run again."""
    r, t = _after_consumed(P, kind), _after_consumed(T, kind)
    assert r[0] and t[0]
    for a, b in zip(r[1:], t[1:]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def _built_before_consumed(M, kind):
    """``y`` is built on ``h`` BEFORE a backward consumes ``h``'s producer;
    ``y.backward()`` then stops at the consumed node and fills ``h.grad``
    (and ``x`` only by the live path of ``mixed``). ``two``: two made
    Tensors of one consuming backward. ``saved``: ``mixed`` through a
    consumed node that saved its input (``x * x``). ``two_live``: ``h``
    feeds two live consumers built before the consuming backward."""
    x = M.to_tensor(A34, stop_gradient=False)
    h = x * x if kind in ("saved", "two_live") else x + 1.0
    g = x * x
    y = {"smallest": lambda: M.sum(h * 3.0),
         "mixed": lambda: M.sum(h * 3.0 + x),
         "saved": lambda: M.sum(h * 3.0 + x),
         "two": lambda: M.sum(h * 3.0 + g * 4.0),
         "two_live": lambda: M.sum(M.tanh(h) * 3.0 + h * x)}[kind]()
    M.sum(h * 2.0 + (g if kind == "two" else 0.0)).backward()
    first = to_np(x.grad).copy()
    y.backward()
    out = [h.is_leaf, first, to_np(x.grad), to_np(h.grad)]
    return out + [to_np(g.grad)] if kind == "two" else out


@pytest.mark.parametrize("kind", ["smallest", "mixed", "two", "saved",
                                  "two_live"])
def test_backward_through_a_graph_built_before_it_was_consumed(kind):
    """``smallest``: ``h = x + 1; y = (h * 3).sum(); (h * 2).sum()
    .backward(); y.backward()`` gives ``x.grad`` 2 and ``h.grad`` 3, as
    the reference's walk, which stops at the dropped tape node. ``mixed``
    and ``saved``: ``x`` is reached through the consumed node and
    directly; only the live path adds to it. ``two_live``: both of ``h``'s
    live consumers add to ``h.grad``, and ``x`` gets only ``h * x``'s
    direct share."""
    r, t = _built_before_consumed(P, kind), _built_before_consumed(T, kind)
    if kind == "smallest":
        np.testing.assert_allclose(t[2], 2.0)
        np.testing.assert_allclose(t[3], 3.0)
    if kind == "two_live":
        h = A34 * A34
        np.testing.assert_allclose(t[2], 4.0 * A34 + h, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(t[3], 3.0 * (1.0 - np.tanh(h) ** 2) + A34,
                                   rtol=TOL, atol=TOL)
    assert r[0] and t[0]
    for a, b in zip(r[1:], t[1:]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_grad_through_a_consumed_node_takes_the_made_tensor():
    """paddle.grad of a graph built before the consuming backward, with
    respect to the Tensor the consumed node made."""
    out = []
    for M in (P, T):
        x = M.to_tensor(A34, stop_gradient=False)
        h = x * x
        y = M.sum(h * 3.0)
        M.sum(h * 2.0).backward()
        (gh,) = M.grad(y, [h])
        out.append((to_np(gh), to_np(x.grad)))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_backward_through_a_graph_built_before_it_was_consumed_raises():
    """The smallest input that raised until the consumed node kept its
    saved tensors: a leaf reached both through a consumed node that saved
    its input (``x * x``) and through a live path. The reference's walk
    stops at the consumed node: ``x.grad`` becomes ``4x + 1`` and
    ``h.grad`` 3, on both packages, and nothing raises."""
    out = {}
    for M in (P, T):
        x = M.to_tensor(A34, stop_gradient=False)
        h = x * x
        y = M.sum(h * 3.0 + x)
        M.sum(h * 2.0).backward()
        y.backward()
        out[M] = (to_np(x.grad), to_np(h.grad))
    np.testing.assert_allclose(out[T][0], 4.0 * A34 + 1.0, rtol=TOL)
    np.testing.assert_allclose(out[T][1], 3.0, rtol=TOL)
    for a, b in zip(out[P], out[T]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_grad_accumulates_until_clear_grad():
    out = {}
    for M in (P, T):
        x = M.to_tensor(A34, stop_gradient=False)
        M.sum(x * 3.0).backward()
        M.sum(M.tanh(x)).backward()
        acc = to_np(x.grad).copy()
        x.clear_grad()
        assert x.grad is None
        M.sum(x).backward()
        out[M] = (acc, to_np(x.grad))
    for a, b in zip(out[P], out[T]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_register_hook_scales_the_gradient():
    res = {}
    for M in (P, T):
        x = M.to_tensor(A34, stop_gradient=False)
        h = M.tanh(x)
        h.register_hook(lambda g: g * 2.0)
        handle = x.register_hook(lambda g: g + 1.0)
        M.sum(h * h).backward()
        res[M] = to_np(x.grad)
        handle.remove()
    np.testing.assert_allclose(res[T], res[P], rtol=TOL, atol=TOL)


def test_inplace_ops_and_setitem():
    for M in (P, T):
        t = M.to_tensor([1.0, 4.0])
        t.add_(M.to_tensor([1.0, 1.0]))
        t.sqrt_()
        np.testing.assert_allclose(to_np(t), np.sqrt([2.0, 5.0]), rtol=1e-6)
        z = M.zeros([3, 3])
        z[0, 0] = 5.0
        z[1] = M.ones([3])
        assert z[0, 0].item() == 5.0 and to_np(z)[1].tolist() == [1, 1, 1]
        leaf = M.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(RuntimeError, match="in-place"):
            leaf.add_(M.to_tensor([1.0]))
        # through an in-place op on a non-leaf the gradient still flows
        x = M.to_tensor(A34, stop_gradient=False)
        y = x * 2.0
        y.add_(x)
        M.sum(y).backward()
        np.testing.assert_allclose(to_np(x.grad), np.full((3, 4), 3.0))


def test_tensor_surface():
    for M in (P, T):
        t = M.to_tensor(D234)
        assert t.shape == [2, 3, 4] and t.ndim == 3 and t.size == 24
        assert len(t) == 2 and [r.shape for r in t] == [[3, 4]] * 2
        assert isinstance(t[0, 0, 0].item(), float)
        assert float(t[1, 2, 3]) == pytest.approx(float(D234[1, 2, 3]))
        assert t[t > 0].shape == [int((D234 > 0).sum())]
        assert "Tensor" in repr(t)
        np.testing.assert_array_equal(np.asarray(t), D234)
        assert t.T.shape == [4, 3, 2]
        assert t.astype("int32").dtype == np.int32


def test_pylayer_and_paddle_grad():
    res = {}
    for M in (P, T):
        class Cube(M.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x * x

            @staticmethod
            def backward(ctx, g):
                x, = ctx.saved_tensor
                return g * 3.0 * x * x

        x = M.to_tensor(A34, stop_gradient=False)
        y = Cube.apply(x)
        M.sum(y).backward()
        z = M.to_tensor(B34, stop_gradient=False)
        out = M.sum(M.tanh(z) * z)
        gz, = M.grad(out, z, create_graph=True)
        gg, = M.grad(M.sum(gz), z)
        res[M] = (to_np(y), to_np(x.grad), to_np(gz), to_np(gg))
    for a, b in zip(res[P], res[T]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_saved_tensors_hooks_pack_and_unpack():
    res = {}
    for M in (P, T):
        seen = []

        def pack(t):
            seen.append(tuple(t.shape))
            return t.numpy()

        def unpack(a):
            return M.to_tensor(a)

        x = M.to_tensor(A34, stop_gradient=False)
        with M.autograd.saved_tensors_hooks(pack, unpack):
            y = M.sum(M.exp(x) * x)
        y.backward()
        res[M] = (bool(seen), to_np(x.grad))
    assert res[T][0] and res[P][0]
    np.testing.assert_allclose(res[T][1], res[P][1], rtol=TOL, atol=TOL)


RANDOM = [
    ("rand", lambda M: M.rand([3, 5])),
    ("randn", lambda M: M.randn([4, 5])),
    ("uniform", lambda M: M.uniform([7], min=-2.0, max=3.0)),
    ("normal", lambda M: M.normal(1.0, 2.0, [6])),
    ("randint", lambda M: M.randint(0, 10, [50])),
    ("randint_span", lambda M: M.randint(-70000, 90000, [40])),
    ("randperm", lambda M: M.randperm(33)),
    ("bernoulli", lambda M: M.bernoulli(M.full([40], 0.3))),
    ("multinomial", lambda M: M.multinomial(
        M.to_tensor([0.1, 0.2, 0.7]), 6, replacement=True)),
    ("dropout_mask", lambda M: M.nn.functional.dropout(M.ones([5, 7]),
                                                       0.4)),
]


@pytest.mark.parametrize("name,fn", RANDOM, ids=[r[0] for r in RANDOM])
def test_seeded_random_ops_equal_the_reference_bitwise(name, fn):
    seed_both(11)
    fn(P), fn(T)     # a second draw of the stream must match too
    r, t = fn(P), fn(T)
    assert str(t.dtype) == str(r.dtype)
    np.testing.assert_array_equal(to_np(t), to_np(r))
