"""Training guardrails of the port (paddle_tpu_torch/distributed/ft/
sentinel.py, the training half of ft/chaos.py and
models/gpt.py:build_train_step(sentinel=True)) on the CPU: the scenarios
of tests/test_guardrails.py that need no zero3 mesh, on a small float
layer stack trained with the port's AdamW (the reference drives its own
on zero3), and the GPT sentinel against the reference's.

The oracles are the reference's: a guarded run with an injected NaN
equals, bit for bit, a clean run that skips the same step; a burst of
anomalies rolls back to the last commit and quarantines exactly the
poisoned indices, which ride in the checkpoint aux; the guard refuses to
thrash."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.ft import sentinel as jsent
from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.distributed.ft import (ChaosPlan, CheckpointManager,
                                             StepGuard, chaos, latest_step,
                                             run_guarded)
from paddle_tpu_torch.distributed.ft.sentinel import (
    CODE_GRAD_NONFINITE, CODE_LOSS_NONFINITE, CODE_LOSS_SPIKE, H_APPLIED,
    H_CODE, H_GNORM, H_LOSS, anomaly_code, guarded_update, health_vector)
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops.kernels.fused_adamw import (tree_flatten,
                                                      tree_unflatten)

torch.set_num_threads(1)
L, D, B = 3, 16, 8


def _fresh():
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(0, 0.1, (L, D, D)).astype(
        np.float32)), "b": torch.zeros((L, D))}
    return params, tg.adamw_init(params, device="cpu")


def _loss(params, x, y):
    h = x
    for i in range(L):
        h = h + torch.tanh(h @ params["w"][i] + params["b"][i])
    return ((h - y) ** 2).mean()


def _step(state, x, y, cap):
    """A guarded step of the layer stack: loss and gradients by autograd,
    then the sentinel around the port's AdamW update."""
    params, opt = state
    leaves = [t.detach().requires_grad_() for t in tree_flatten(params)]
    with torch.enable_grad():
        loss = _loss(tree_unflatten(params, leaves), torch.as_tensor(x),
                     torch.as_tensor(y))
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    out, health = guarded_update(
        loss.detach(), grads, cap,
        lambda: tg._adamw_update(params, grads, opt, 1e-2))
    return (out or (params, opt)), health


def _base_data(t):
    drng = np.random.default_rng(300 + t)
    return (drng.normal(size=(B, D)).astype(np.float32),
            drng.normal(size=(B, D)).astype(np.float32))


def _run(n_steps, plan=None, mask=(), guard=None, save_every=0, mgr=None,
         trace=None, max_rollbacks=8):
    plan = plan or ChaosPlan()
    guard = guard or StepGuard(name="test")
    guard.quarantined.update(mask)

    def data_for(t):
        if trace is not None:
            trace.append(t)
        x, y = _base_data(t)
        x, y, _ = chaos.corrupt_batch(plan, t, x, y)
        return x, y

    saver = restorer = None
    if mgr is not None:
        def saver(nxt, state, g):
            mgr.save(nxt, _arrays(state),
                     {"train": {"next_step": int(nxt)},
                      "guard": g.state_dict()})

        def restorer(g):
            # the live guard keeps its pending quarantine: the aux guard
            # state is for a resumed process only
            if latest_step(mgr.directory) is None:
                return None
            arrays, aux, s = mgr.restore()
            return _state(arrays), int(aux["train"]["next_step"])

    state, losses = run_guarded(_step, guard, _fresh(), data_for, n_steps,
                                save_every=save_every, saver=saver,
                                restorer=restorer,
                                max_rollbacks=max_rollbacks)
    if mgr is not None:
        mgr.wait()
    return state, losses, guard


def _all(state):
    """Every tensor of a (params, opt) train state."""
    return list(_arrays(state).values())


def _arrays(state):
    params, opt = state
    out = {f"p/{k}": v for k, v in params.items()}
    out.update({f"m/{k}": v for k, v in opt["m"].items()})
    out.update({f"v/{k}": v for k, v in opt["v"].items()})
    out["step"] = opt["step"]
    return out


def _state(arrays):
    pick = lambda pre: {k[len(pre):]: v for k, v in arrays.items()
                        if k.startswith(pre)}
    return pick("p/"), {"m": pick("m/"), "v": pick("v/"),
                        "step": arrays["step"]}


class TestSentinel:
    def test_clean_guarded_matches_unguarded_bitwise(self):
        s1, s2 = _fresh(), _fresh()
        for t in range(4):
            x, y = _base_data(t)
            p, o = s1
            leaves = [v.detach().requires_grad_() for v in tree_flatten(p)]
            with torch.enable_grad():
                loss = _loss(tree_unflatten(p, leaves), torch.as_tensor(x),
                             torch.as_tensor(y))
                g = torch.autograd.grad(loss, leaves)
            s1 = tg._adamw_update(p, tree_unflatten(p, g), o, 1e-2)
            s2, h = _step(s2, x, y, float("inf"))
            assert float(loss.detach()) == h[H_LOSS]
            assert h[H_APPLIED] == 1.0 and h[H_CODE] == 0.0
            assert torch.isfinite(h[H_GNORM]) and h[H_GNORM] > 0
        for a, b in zip(_all(s1), _all(s2)):
            assert torch.equal(a, b)
        assert int(s2[1]["step"]) == 4

    @pytest.mark.parametrize("poison", [float("nan"), float("inf")])
    def test_poison_masks_update_exactly(self, poison):
        state, state0 = _fresh(), _fresh()
        x, y = _base_data(0)
        x[0, 0] = poison
        state, h = _step(state, x, y, float("inf"))
        assert h[H_APPLIED] == 0.0
        assert int(h[H_CODE]) & CODE_LOSS_NONFINITE
        assert int(h[H_CODE]) & CODE_GRAD_NONFINITE
        for a, b in zip(_all(state), _all(state0)):
            assert torch.equal(a, b)
        assert int(state[1]["step"]) == 0

    def test_anomaly_code_and_health_match_reference(self):
        for loss, sq, cap in ((2.0, 4.0, np.inf), (np.nan, 4.0, np.inf),
                              (2.0, np.inf, np.inf), (5.0, 1.0, 3.0),
                              (np.nan, np.nan, -np.inf)):
            jok, jcode = jsent.anomaly_code(loss, sq, cap)
            ok, code = anomaly_code(torch.tensor(loss), torch.tensor(sq),
                                    cap)
            assert bool(ok) == bool(jok) and float(code) == float(jcode)
            np.testing.assert_array_equal(
                health_vector(torch.tensor(loss), ok, code,
                              torch.tensor(sq)).numpy(),
                np.asarray(jsent.health_vector(loss, jok, jcode, sq)))

    def test_skip_is_deterministic_oracle(self):
        plan = ChaosPlan.parse("nan_grad@step=2")
        _, la, ga = _run(6, plan=plan)
        _, lb, _ = _run(6, mask={2})
        assert ga.anomalies == 1 and ga.skips == 1 and ga.rollbacks == 0
        assert sorted(la) == [0, 1, 3, 4, 5] and sorted(lb) == sorted(la)
        for t in la:
            assert la[t] == lb[t], f"step {t}: {la[t]} != {lb[t]}"

    def test_spike_skip_via_loss_cap(self):
        plan = ChaosPlan.parse("spike_loss@step=4:x40")
        guard = StepGuard(spike_factor=10.0, min_history=3, name="spike")
        _, la, ga = _run(7, plan=plan, guard=guard)
        _, lb, _ = _run(7, mask={4})
        assert ga.anomalies == 1
        assert sorted(la) == [0, 1, 2, 3, 5, 6]
        for t in la:
            assert la[t] == lb[t]

    def test_rollback_restores_last_commit_and_quarantines(self, tmp_path):
        plan = ChaosPlan.parse("nan_grad@step=3-4")
        guard = StepGuard(max_consecutive=2, name="burst")
        mgr = CheckpointManager(str(tmp_path / "ck"), keep=3, name="t")
        trace = []
        _, la, ga = _run(7, plan=plan, guard=guard, save_every=2, mgr=mgr,
                         trace=trace)
        assert ga.rollbacks == 1
        assert sorted(ga.quarantined) == [3, 4]
        assert ga.last_restored_step == 4
        assert sorted(la) == [0, 1, 2, 5, 6]
        _, lb, _ = _run(7, mask={3, 4})
        for t in la:
            assert la[t] == lb[t]
        rb = trace.index(4) + 1
        assert 3 not in trace[rb:] and 4 not in trace[rb:]
        assert trace[rb:] == [5, 6]
        # the quarantine rides in the checkpoint aux: a resumed process
        # keeps skipping the poisoned indices
        _, aux, _ = mgr.restore()
        assert aux["guard"]["quarantined"] == [3, 4]
        g2 = StepGuard(name="resumed")
        g2.load_state_dict(aux["guard"])
        assert g2.quarantined == {3, 4} and g2.rollbacks == 1

    def test_rollback_without_commit_continues_in_place(self):
        plan = ChaosPlan.parse("nan_grad@step=1-2")
        guard = StepGuard(max_consecutive=2, name="nocommit")
        _, la, ga = _run(5, plan=plan, guard=guard)
        assert ga.rollbacks == 1 and ga.last_restored_step is None
        assert sorted(ga.quarantined) == [1, 2]
        assert sorted(la) == [0, 3, 4]
        _, lb, _ = _run(5, mask={1, 2})
        for t in la:
            assert la[t] == lb[t]

    def test_guard_refuses_to_thrash(self):
        plan = ChaosPlan.parse("nan_grad@step=0-19")
        guard = StepGuard(max_consecutive=2, name="thrash")
        with pytest.raises(RuntimeError, match="refusing to thrash"):
            _run(20, plan=plan, guard=guard, max_rollbacks=0)


def _gpt_all(params, opt):
    return list(tg.train_state_arrays(params, opt).values())


class TestGPTSentinel:
    @pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
    def test_gpt_sentinel_matches_reference_and_masks(self, fused):
        """A healthy guarded step equals the unguarded one bit for bit and
        the reference's health to f32 tolerance; a force-masked step
        (loss_cap=-1) and a NaN in the weights change nothing, the step
        counter included."""
        kw = dict(vocab_size=64, hidden=32, n_layers=2, n_heads=2,
                  max_seq=16, micro_batches=1, remat=False)
        cfg_j = jg.GPTConfig(**kw)
        cfg_t = tg.GPTConfig(dtype=torch.float32, fused_adamw=fused, **kw)
        tree = jax.device_get(jg.init_params(
            dataclasses.replace(cfg_j, dtype=jnp.float32), seed=0))
        rng = np.random.default_rng(0)
        tok = rng.integers(0, 64, (8, 16)).astype(np.int32)
        lab = rng.integers(0, 64, (8, 16)).astype(np.int32)
        cfg_j = dataclasses.replace(cfg_j, dtype=jnp.float32)
        mesh = jg.make_mesh(cfg_j, devices=np.array(jax.devices()[:1]))
        jstep, shard = jg.build_spmd_train_step(cfg_j, mesh, lr=1e-3,
                                                sentinel=True)
        pj, oj = shard(jax.tree_util.tree_map(jnp.asarray, tree))
        _, _, hj = jstep(pj, oj, jnp.asarray(tok), jnp.asarray(lab),
                         float("inf"))
        hj = np.asarray(hj)

        fresh = lambda: (lambda p: (p, tg.adamw_init(p, device="cpu")))(
            tg.params_from_numpy(tree, cfg_t, device="cpu"))
        step = tg.build_train_step(cfg_t, lr=1e-3, device="cpu")
        guarded = tg.build_train_step(cfg_t, lr=1e-3, device="cpu",
                                      sentinel=True)
        p1, o1, loss = step(*fresh(), tok, lab)
        p2, o2, h = guarded(*fresh(), tok, lab, float("inf"))
        assert float(loss) == float(h[H_LOSS]) and h[H_APPLIED] == 1.0
        for a, b in zip(_gpt_all(p1, o1), _gpt_all(p2, o2)):
            assert torch.equal(a, b)
        np.testing.assert_allclose(float(h[H_LOSS]), hj[H_LOSS], rtol=1e-5)
        np.testing.assert_allclose(float(h[H_GNORM]), hj[H_GNORM],
                                   rtol=1e-4)
        assert hj[H_APPLIED] == 1.0 and hj[H_CODE] == 0.0
        # force-masked, through loss_cap
        p0, o0 = fresh()
        p3, o3, h3 = guarded(*fresh(), tok, lab, -1.0)
        assert h3[H_APPLIED] == 0.0 and int(h3[H_CODE]) & CODE_LOSS_SPIKE
        for a, b in zip(_gpt_all(p3, o3), _gpt_all(p0, o0)):
            assert torch.equal(a, b)
        # a NaN in the weights: loss and gradients non-finite
        p4, o4 = fresh()
        p4["wpe"][0, 0] = float("nan")
        bits = [t.clone() for t in _gpt_all(p4, o4)]
        p4, o4, h4 = guarded(p4, o4, tok, lab, float("inf"))
        assert h4[H_APPLIED] == 0.0 and int(h4[H_CODE]) == (
            CODE_LOSS_NONFINITE | CODE_GRAD_NONFINITE)
        for a, b in zip(_gpt_all(p4, o4), bits):
            # compared as bits: the poisoned element is a NaN
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert int(o4["step"]) == 0


class TestChaosTrainingFaults:
    def test_corrupt_batch_is_exact(self):
        plan = ChaosPlan.parse("nan_grad@step=2,spike_loss@step=3:x4,"
                               "inf_grad@step=5")
        x0 = np.ones((2, 3), np.float32)
        y0 = np.ones((2, 3), np.float32)
        x, y, inj = chaos.corrupt_batch(plan, 1, x0, y0)
        assert inj == [] and x is x0 and y is y0
        x, y, inj = chaos.corrupt_batch(plan, 2, x0, y0)
        assert inj == ["nan_grad"] and np.isnan(x[0, 0])
        assert np.isfinite(x0[0, 0])
        x, y, inj = chaos.corrupt_batch(plan, 3, x0, y0)
        assert inj == ["spike_loss"] and np.all(y == 4.0)
        # tensors too, copied
        xt, yt = torch.ones(2, 3), torch.ones(2, 3)
        x, y, inj = chaos.corrupt_batch(plan, 5, xt, yt)
        assert inj == ["inf_grad"] and torch.isinf(x[0, 0])
        assert torch.isfinite(xt).all() and y is yt

    def test_ckpt_write_fail_preserves_previous_commit(self, tmp_path):
        plan = ChaosPlan.parse("ckpt_write_fail@save=2")
        hook = chaos.install_ckpt_faults(plan)
        try:
            mgr = CheckpointManager(str(tmp_path / "ck"), keep=3,
                                    name="chaos", writer="numpy")
            mgr.save(1, {"a": torch.arange(4)}, blocking=True)
            assert mgr.all_steps() == [1]
            with pytest.raises(RuntimeError,
                               match="previous committed step"):
                mgr.save(2, {"a": torch.arange(4) * 2}, blocking=False)
                mgr.wait()
            assert mgr.all_steps() == [1]
            arrays, _, step = mgr.restore(1)
            assert step == 1 and torch.equal(arrays["a"], torch.arange(4))
            assert hook.commits == 2
        finally:
            chaos.clear_ckpt_faults()
        assert chaos.install_ckpt_faults(
            ChaosPlan.parse("nan_grad@step=1")) is None

    def test_kill_fires_at_exact_step(self, monkeypatch):
        import os
        calls = []
        monkeypatch.setattr(os, "kill", lambda pid, sig:
                            calls.append((pid, sig)))
        plan = ChaosPlan.parse("kill@step=11")
        chaos.maybe_kill(plan, 10)
        assert calls == []
        chaos.maybe_kill(plan, 11)
        assert len(calls) == 1 and calls[0][0] == os.getpid()


class TestStepGuardPolicy:
    def test_loss_cap_arms_after_min_history(self):
        g = StepGuard(spike_factor=4.0, min_history=3, name="cap")
        assert g.loss_cap() == float("inf")
        for i, loss in enumerate((2.0, 4.0, 3.0)):
            g.observe(i, torch.tensor([loss, 1.0, 0.0, 1.0]))
        assert g.loss_cap() == pytest.approx(12.0)

    def test_consecutive_resets_on_healthy(self):
        g = StepGuard(max_consecutive=3, name="cons")
        bad = [float("nan"), 0.0, 3.0, float("nan")]
        assert g.observe(0, bad) == "skip"
        assert g.observe(1, bad) == "skip"
        assert g.observe(2, [1.0, 1.0, 0.0, 1.0]) == "ok"
        assert g.observe(3, bad) == "skip"
        assert g.observe(4, bad) == "skip"
        assert g.observe(5, bad) == "rollback"

    def test_state_dict_roundtrip_and_bad_config(self):
        g = StepGuard(name="rt")
        g.observe(0, [1.0, 1.0, 0.0, 1.0])
        g.observe(1, [float("nan"), 0.0, 3.0, 1.0])
        g.rolled_back(1)
        g2 = StepGuard(name="rt2")
        g2.load_state_dict(g.state_dict())
        assert g2.quarantined == {1}
        assert g2.rollbacks == 1 and g2.anomalies == 1
        assert g2.loss_cap() == g.loss_cap()
        with pytest.raises(ValueError):
            StepGuard(spike_factor=1.0)
        with pytest.raises(ValueError):
            StepGuard(max_consecutive=0)
