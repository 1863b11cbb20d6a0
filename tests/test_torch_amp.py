"""The port's amp against the reference's on the CPU: auto_cast O1 and O2
(bf16) losses and gradients of LeNet and the eager GPT, operator stats by
dtype, a float16 GradScaler run (scale trajectory and skipped steps), the
one-host-read rule of unscale_, and tests/test_amp_debugging.py's cases
replayed against the port."""
import numpy as np
import pytest

from torch_eager_ref import P, T, load_reference_state, seed_both, to_np

_RNG = np.random.default_rng(43)
DIGITS = _RNG.standard_normal((3, 8, 1, 28, 28)).astype(np.float32)
DLAB = _RNG.integers(0, 10, (3, 8)).astype(np.int64)
TOK = _RNG.integers(0, 256, (2, 129)).astype(np.int64)

# bf16 losses, port against reference: both round the same white-list
# inputs to bf16 and accumulate in f32, but XLA's CPU dot and convolution
# and torch's CPU kernels sum in different orders, so the losses agree to
# a few bf16 steps (2^-8 each), not bitwise
AMP_LOSS_TOL = 2e-2
# bf16 gradients: a conv weight's gradient sums many bf16 products with
# cancellation, so on either side it is up to ~25 % (relative to its
# largest element) away from the f32 gradient, and the two sides differ
# by as much. The oracle is the f32 gradient: the port's bf16 gradient
# must be no farther from it than the reference's is, by a factor of 1.5
# plus a floor of one bf16 step
AMP_GRAD_FACTOR = 1.5
AMP_GRAD_FLOOR = 2 ** -8


def _models(name):
    seed_both(0)
    if name == "lenet":
        from paddle_tpu.models import LeNet as RefLeNet
        from paddle_tpu_torch.models import LeNet
        ref, port = RefLeNet(), LeNet()
    else:
        import dataclasses

        from paddle_tpu.models import gpt as rg
        from paddle_tpu_torch.models import gpt as tg
        ref = rg.GPT(dataclasses.replace(rg.gpt_tiny(), max_seq=128,
                                         n_layers=2))
        port = tg.GPT(tg.gpt_tiny(max_seq=128, n_layers=2))
    load_reference_state(port, ref)
    return ref, port


def _loss(M, name, model, step=0):
    if name == "lenet":
        out = model(M.to_tensor(DIGITS[step]))
        return M.nn.functional.cross_entropy(out, M.to_tensor(DLAB[step]))
    logits = model(M.to_tensor(TOK[:, :-1]))
    return M.nn.functional.cross_entropy(
        M.reshape(logits, [-1, logits.shape[-1]]),
        M.to_tensor(TOK[:, 1:].reshape(-1)))


def _rel(a, b):
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", ["lenet", "gpt"])
def test_auto_cast_bf16_losses_and_grads_match_the_reference(name, level):
    ref, port = _models(name)
    # the f32 gradients (the port's equal the reference's to f32 rounding,
    # tests/test_torch_eager_models.py)
    _loss(T, name, port).backward()
    f32 = {n: to_np(p.grad) for n, p in port.named_parameters()}
    for p in port.parameters():
        p.clear_gradient()
    res = {}
    for M, model in ((P, ref), (T, port)):
        if level == "O2":
            M.amp.decorate(model, level="O2", dtype="bfloat16")
        with M.amp.auto_cast(level=level, dtype="bfloat16"):
            loss = _loss(M, name, model)
        loss.backward()
        res[M] = (float(loss), {n: p.grad for n, p in
                                model.named_parameters()})
    (lr, gr), (lt, gt) = res[P], res[T]
    assert abs(lt - lr) <= AMP_LOSS_TOL * max(abs(lr), 1.0), (lt, lr)
    assert gr.keys() == gt.keys() == f32.keys()
    for k in gr:
        assert str(gt[k].dtype).split(".")[-1] == \
            str(gr[k].dtype).split(".")[-1], k
        ref_err, port_err = _rel(f32[k], gr[k]), _rel(f32[k], gt[k])
        assert port_err <= AMP_GRAD_FACTOR * ref_err + AMP_GRAD_FLOOR, \
            (k, port_err, ref_err)


def test_operator_stats_by_dtype_equal_the_reference(capsys):
    ref, port = _models("lenet")
    stats = {}
    for M, model in ((P, ref), (T, port)):
        with M.amp.auto_cast(dtype="bfloat16"):
            M.amp.enable_operator_stats_collection()
            try:
                _loss(M, "lenet", model)
            finally:
                stats[M] = M.amp.disable_operator_stats_collection()
    assert stats[T] == stats[P]
    assert stats[T][("conv2d", "bfloat16")] == 2
    assert stats[T][("amp_cast", "bfloat16")] > 0


def test_float16_grad_scaler_trajectory_equals_the_reference():
    """LeNet under auto_cast(float16) from paddle's default scale 2^16,
    doubling every 2 good steps: at 2^17 the f16 backward overflows, the
    step is skipped (every parameter bitwise unchanged) and the scale
    halves, twice in 8 steps. Scales, skips and losses equal the
    reference's."""
    ref, port = _models("lenet")
    runs = {}
    for M, model in ((P, ref), (T, port)):
        opt = M.optimizer.Adam(1e-3, parameters=model.parameters())
        scaler = M.amp.GradScaler(init_loss_scaling=2.0 ** 16,
                                  incr_every_n_steps=2)
        out = []
        for step in range(8):
            with M.amp.auto_cast(dtype="float16"):
                loss = _loss(M, "lenet", model, step % 3)
            before = [to_np(p).copy() for p in model.parameters()]
            scaler.scale(loss).backward()
            scaler.unscale_(opt)
            found = scaler._found_inf
            if not found:
                opt.step()
            scaler.update()
            opt.clear_grad()
            if found:
                assert all(np.array_equal(b, to_np(p)) for b, p in
                           zip(before, model.parameters()))
            out.append((scaler.get_init_loss_scaling(), found, float(loss)))
        runs[M] = out
    scales = [[(s, f) for s, f, _ in runs[M]] for M in (P, T)]
    assert scales[1] == scales[0], runs
    assert sum(f for _, f in scales[1]) == 2 and not scales[1][-1][1]
    np.testing.assert_allclose([x for *_, x in runs[T]],
                               [x for *_, x in runs[P]], rtol=2e-2)


def test_float16_auto_cast_trains_the_eager_gpt():
    """The eager GPT under auto_cast(float16) with a GradScaler: the
    attention runs the flash route in f16 (its plain version here), the
    loss is the f32 loss to f16 rounding and the step applies."""
    _, port = _models("gpt")
    f32 = float(_loss(T, "gpt", port))
    opt = T.optimizer.AdamW(1e-3, parameters=port.parameters())
    scaler = T.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    with T.amp.auto_cast(dtype="float16"):
        loss = _loss(T, "gpt", port)
    scaler.scale(loss).backward()
    before = to_np(port.wte.weight).copy()
    scaler.step(opt)
    assert not scaler._found_inf
    assert not np.array_equal(before, to_np(port.wte.weight))
    assert abs(float(loss) - f32) <= 5e-3 * abs(f32)


class _FakeOpt:
    def __init__(self, grads):
        self._parameters_flat = []
        for g in grads:
            p = T.create_parameter([1] if g is None else list(g.shape),
                                   "float32")
            if g is not None:
                p.grad = T.to_tensor(g)._value
            self._parameters_flat.append(p)
        self.stepped = 0

    def step(self):
        self.stepped += 1


def test_unscale_reads_the_host_once_for_the_whole_tree(monkeypatch):
    """TestGradScalerSatellite's rule on the port: one fused reduction and
    one host read, however many parameters."""
    from paddle_tpu_torch.amp import grad_scaler as gs
    calls = []
    real = gs._tree_found_inf
    monkeypatch.setattr(gs, "_tree_found_inf",
                        lambda grads: calls.append(len(grads))
                        or real(grads))
    scaler = gs.GradScaler(init_loss_scaling=4.0)
    opt = _FakeOpt([np.ones(3, np.float32) * 4.0,
                    np.ones(2, np.float32) * 8.0, None])
    scaler.unscale_(opt)
    assert calls == [2] and not scaler._found_inf
    np.testing.assert_allclose(opt._parameters_flat[0].grad.numpy(), 1.0)
    np.testing.assert_allclose(opt._parameters_flat[1].grad.numpy(), 2.0)
    bad = _FakeOpt([np.array([1.0, np.nan], np.float32)])
    scaler = gs.GradScaler(init_loss_scaling=2.0)
    scaler.step(bad)
    assert bad.stepped == 0 and scaler.get_init_loss_scaling() == 1.0
    sd = gs.GradScaler(init_loss_scaling=8.0).state_dict()
    twin = gs.GradScaler()
    twin.load_state_dict(dict(sd, found_inf=True))
    twin.update()
    assert twin.get_init_loss_scaling() == 4.0


# ---------------------------------- tests/test_amp_debugging.py, on the port
def test_operator_stats_collection():
    amp = T.amp
    with amp.collect_operator_stats():
        x = T.to_tensor(np.ones((4, 4), "float32"))
        y = x @ x
        y.sum()
    amp.enable_operator_stats_collection()
    T.to_tensor(np.ones(3, "float32")) + 1.0
    stats = amp.disable_operator_stats_collection()
    assert any(op == "add" for (op, _dtype) in stats), stats
    assert all(n > 0 for n in stats.values())


def test_tensor_checker_aborts_on_nan(tmp_path):
    amp = T.amp
    amp.enable_tensor_checker(amp.TensorCheckerConfig(
        output_dir=str(tmp_path / "dump")))
    try:
        bad = T.to_tensor(np.array([1.0, 0.0], "float32"))
        with pytest.raises(FloatingPointError):
            _ = bad / bad
    finally:
        amp.disable_tensor_checker()


def test_tensor_checker_op_filters():
    amp = T.amp
    amp.enable_tensor_checker(amp.TensorCheckerConfig(
        checked_op_list=["matmul"]))
    try:
        bad = T.to_tensor(np.array([1.0, 0.0], "float32"))
        _ = bad / bad            # divide not in the checked list
        amp.enable_tensor_checker(amp.TensorCheckerConfig(
            skipped_op_list=["divide"]))
        _ = bad / bad            # divide skipped
    finally:
        amp.disable_tensor_checker()


def test_check_numerics_counts():
    amp = T.amp
    t = T.to_tensor(np.array([1.0, 0.0, np.inf], "float32"))
    n_nan, n_inf, n_zero = amp.check_numerics(
        t, "op", "v", amp.DebugMode.CHECK_NAN_INF)
    assert (int(n_nan), int(n_inf), int(n_zero)) == (0, 1, 1)
    with pytest.raises(FloatingPointError):
        amp.check_numerics(t, "op", "v",
                           amp.DebugMode.CHECK_NAN_INF_AND_ABORT)


def test_dump_and_compare_accuracy(tmp_path):
    amp = T.amp
    for d in ("a", "b"):
        amp.enable_tensor_checker(amp.TensorCheckerConfig(
            output_dir=str(tmp_path / d),
            debug_mode=amp.DebugMode.CHECK_NAN_INF))
        try:
            x = T.to_tensor(np.ones(3, "float32"))
            _ = x * 2.0
        finally:
            amp.disable_tensor_checker()
    rows = amp.compare_accuracy(str(tmp_path / "a"), str(tmp_path / "b"),
                                str(tmp_path / "cmp.csv"))
    assert rows and all(r["flag"] == "" for r in rows)
    assert (tmp_path / "cmp.csv").exists()


def test_checker_step_range():
    cfg = T.amp.TensorCheckerConfig(debug_step=(1, 2))
    assert cfg.update_and_check_step_id() is True
    assert cfg.update_and_check_step_id() is True
    assert cfg.update_and_check_step_id() is False
    assert cfg._should_check("matmul") is False


def test_checker_step_range_gates_observer_via_optimizer():
    amp = T.amp
    net = T.nn.Linear(2, 2)
    opt = T.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    amp.enable_tensor_checker(amp.TensorCheckerConfig(debug_step=(1, 1)))
    try:
        bad = T.to_tensor(np.array([1.0, 0.0], "float32"))
        opt.step()                      # the checker's step 1
        with pytest.raises(FloatingPointError):
            _ = bad / bad
        opt.step()                      # step 2: outside the range
        _ = bad / bad
    finally:
        amp.disable_tensor_checker()
