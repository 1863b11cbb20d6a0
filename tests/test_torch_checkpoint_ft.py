"""Fault-tolerant training of the port on the CPU
(paddle_tpu_torch/distributed/ft/{atomic,reshard,manager}.py and
distributed/checkpoint.py): the scenarios of tests/test_checkpoint_ft.py
that need no zero3 mesh, on the port's GPT train state. Async saves
restore bit for bit like blocking ones, bf16 included; a crash between
the staging write and the rename leaves the previous commit; committed
steps are immutable; stale staging dirs and old steps are pruned; the
reshard plans equal the reference's; a step either package wrote
restores in the other bit for bit; a restore into another model fails
loudly; SIGTERM runs a final save; a SIGKILLed trainer resumes on the
uninterrupted trajectory; the save/commit/restore events reach the
telemetry plane; and the wait deadlines of the manager and of
``distributed.checkpoint`` raise naming what is stuck."""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed.ft import CheckpointManager as JManager
from paddle_tpu.distributed.ft import reshard as jreshard
from paddle_tpu_torch.distributed import checkpoint as dckpt
from paddle_tpu_torch.distributed.ft import (CheckpointManager, atomic,
                                             install_preemption_handler,
                                             latest_step, reshard)
from paddle_tpu_torch.models import gpt as tg

torch.set_num_threads(1)


def _trained_state(dtype=torch.float32, steps=2):
    cfg = tg.gpt_tiny(n_layers=2, remat=False, dtype=dtype)
    params = tg.init_params(cfg, seed=0, device="cpu")
    opt = tg.adamw_init(params, device="cpu")
    step = tg.build_train_step(cfg, lr=1e-2, device="cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17))
    for _ in range(steps):
        params, opt, _ = step(params, opt, tok[:, :-1], tok[:, 1:])
    return cfg, params, opt


def _assert_state_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert torch.equal(x, y), k


# ---------------------------------------------------------------- writers
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_async_save_roundtrip_bit_exact_vs_sync(tmp_path, dtype):
    cfg, params, opt = _trained_state(dtype)
    arrays = tg.train_state_arrays(params, opt)
    aux = {"train": {"next_step": 2}}
    m_async = CheckpointManager(tmp_path / "a", keep=3)
    m_sync = CheckpointManager(tmp_path / "s", keep=3)
    m_async.save(2, arrays, aux)
    m_sync.save(2, arrays, aux, blocking=True)
    m_async.wait()
    got_a, aux_a, step_a = m_async.restore()
    got_s, aux_s, step_s = m_sync.restore()
    assert step_a == step_s == 2 and aux_a == aux_s == aux
    _assert_state_equal(got_a, got_s)
    _assert_state_equal(got_a, arrays)
    p2, o2 = tg.restore_train_state(got_a, cfg, device="cpu")
    _assert_state_equal(tg.train_state_arrays(p2, o2), arrays)


def test_save_snapshots_before_an_update_in_place(tmp_path):
    """The host copy is taken in the caller's thread: a tensor updated in
    place right after ``save`` returns does not reach the write."""
    m = CheckpointManager(tmp_path)
    t = torch.arange(6, dtype=torch.float32)
    m.save(1, {"t": t})
    t.add_(100.0)
    m.wait()
    assert torch.equal(m.restore()[0]["t"], torch.arange(
        6, dtype=torch.float32))


def test_orbax_writer_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CKPT_WRITER", "orbax")
    with pytest.raises(RuntimeError, match="orbax"):
        CheckpointManager("/nonexistent-not-created")


# ---------------------------------------------------------- commit safety
def test_crash_mid_save_leaves_previous_checkpoint(tmp_path):
    _, params, opt = _trained_state()
    arrays = tg.train_state_arrays(params, opt)
    m = CheckpointManager(tmp_path, keep=3)
    m.save(1, arrays, blocking=True)

    def boom():
        raise OSError("simulated preemption between write and rename")

    atomic.set_fault_hook(boom)
    try:
        m.save(2, arrays)
        with pytest.raises(RuntimeError, match="previous .* intact"):
            m.wait()
    finally:
        atomic.set_fault_hook(None)
    assert m.all_steps() == [1]
    got, _, step = m.restore()
    assert step == 1
    _assert_state_equal(got, arrays)
    m.save(2, arrays)
    m.wait()
    assert m.all_steps() == [1, 2]


def test_recommit_of_committed_step_never_deletes_it(tmp_path):
    m = CheckpointManager(tmp_path)
    m.save(4, {"a": torch.ones(3)}, blocking=True)
    m.save(4, {"a": torch.full((3,), 2.0)}, blocking=True)
    assert m.all_steps() == [4]
    assert torch.equal(m.restore()[0]["a"], torch.ones(3))
    assert not os.path.exists(
        os.path.join(tmp_path, "step_00000004" + atomic.TMP_SUFFIX))


def test_prune_stale_staging_and_keep_policy(tmp_path):
    stale = tmp_path / ("step_00000001" + atomic.TMP_SUFFIX)
    inflight = tmp_path / ("step_00000099" + atomic.TMP_SUFFIX)
    stale.mkdir(parents=True)
    inflight.mkdir()
    m = CheckpointManager(tmp_path, keep=2)
    for s in (2, 3, 4):
        m.save(s, {"a": torch.full((4,), float(s))}, blocking=True)
    assert not stale.exists() and inflight.exists()
    assert m.all_steps() == [3, 4] and latest_step(str(tmp_path)) == 4
    got, _, step = m.restore()
    assert step == 4 and got["a"][0] == 4.0


# ------------------------------------------------------------- reshard
def test_reshard_plans_match_reference():
    size = 37
    flat = np.arange(2 * size, dtype=np.float32).reshape(2, size)
    for src_n in (1, 2, 4, 8):
        slices = reshard.repad(flat, src_n)
        np.testing.assert_array_equal(slices, jreshard.repad(flat, src_n))
        for dst_n in (1, 2, 4, 8):
            assert reshard.plan_reshard(size, src_n, dst_n) == \
                jreshard.plan_reshard(size, src_n, dst_n)
            whole = reshard.reshard(slices, size, dst_n)
            np.testing.assert_array_equal(
                whole, jreshard.reshard(slices, size, dst_n))
            np.testing.assert_array_equal(
                reshard.apply_plan(slices, size, dst_n), whole)
            np.testing.assert_array_equal(reshard.depad(whole, size), flat)


# ----------------------------------------------------------- cross-read
def test_checkpoints_cross_read_between_packages(tmp_path):
    """The on-disk layout is the reference's numpy layout: a step the
    reference wrote restores in the port bit for bit, and the other way
    round (bf16, f32 and int32 leaves)."""
    rng = np.random.default_rng(3)
    ref_state = {
        "bf": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
        "f32": jnp.asarray(rng.normal(size=(4,)), jnp.float32),
        "step": jnp.asarray(7, jnp.int32)}
    JManager(str(tmp_path / "ref"), writer="numpy").save(
        3, ref_state, {"note": "ref"}, blocking=True)
    got, aux, step = CheckpointManager(tmp_path / "ref").restore()
    assert step == 3 and aux == {"note": "ref"}
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["bf"].view(torch.int16).numpy(),
        np.asarray(ref_state["bf"]).view(np.int16))
    np.testing.assert_array_equal(got["f32"].numpy(),
                                  np.asarray(ref_state["f32"]))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7

    _, params, opt = _trained_state(torch.bfloat16)
    arrays = tg.train_state_arrays(params, opt)
    CheckpointManager(tmp_path / "port").save(5, arrays, {"n": 1},
                                              blocking=True)
    back, aux, step = JManager(str(tmp_path / "port"),
                               writer="numpy").restore()
    assert step == 5 and aux == {"n": 1}
    for k, t in arrays.items():
        want = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                else t.numpy())
        have = np.asarray(back[k])
        if t.dtype == torch.bfloat16:
            assert str(have.dtype) == "bfloat16"
            have = have.view(np.int16)
        np.testing.assert_array_equal(have, want, err_msg=k)


def test_restore_rejects_another_model(tmp_path):
    cfg, params, opt = _trained_state()
    m = CheckpointManager(tmp_path)
    m.save(1, tg.train_state_arrays(params, opt), blocking=True)
    arrays, _, _ = m.restore()
    with pytest.raises(ValueError, match="another model|wants"):
        tg.restore_train_state(arrays, tg.gpt_tiny(n_layers=3),
                               device="cpu")
    with pytest.raises(ValueError, match="wants"):
        tg.restore_train_state(arrays, tg.gpt_tiny(
            n_layers=2, remat=False, opt_dtype=torch.bfloat16),
            device="cpu")


# ------------------------------------------------------------ preemption
def test_sigterm_triggers_final_blocking_save(tmp_path):
    _, params, opt = _trained_state()
    m = CheckpointManager(tmp_path)

    def final_save():
        m.save(7, tg.train_state_arrays(params, opt), blocking=True)

    handler = install_preemption_handler(final_save, exit_after=False)
    try:
        assert m.all_steps() == []
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not handler.triggered and time.time() < deadline:
            time.sleep(0.01)
        assert handler.triggered and handler.saved
        assert m.all_steps() == [7]
        _assert_state_equal(m.restore()[0],
                            tg.train_state_arrays(params, opt))
    finally:
        handler.uninstall()


def test_sigkill_resume_matches_uninterrupted_trajectory(tmp_path):
    script = os.path.join(os.path.dirname(__file__),
                          "_torch_ckpt_trainer.py")
    steps = 8
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def run(ckpt_dir, *extra):
        out = subprocess.run(
            [sys.executable, script, str(ckpt_dir), "--steps", str(steps),
             "--save-every", "2", *extra],
            capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads([ln for ln in out.stdout.splitlines()
                           if ln.startswith("{")][-1])

    full = run(tmp_path / "full")
    assert len(full["losses"]) == steps
    kill_dir = tmp_path / "killed"
    proc = subprocess.Popen(
        [sys.executable, script, str(kill_dir), "--steps", str(steps),
         "--save-every", "2", "--step-sleep-ms", "400"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.time() + 240
        while time.time() < deadline and latest_step(str(kill_dir)) is None:
            if proc.poll() is not None:
                pytest.fail("trainer exited before any commit: "
                            + (proc.stderr.read() or "")[-2000:])
            time.sleep(0.05)
        proc.kill()
    finally:
        proc.wait()
        for f in (proc.stdout, proc.stderr):
            f.close()
    assert proc.returncode == -signal.SIGKILL
    committed = latest_step(str(kill_dir))
    assert committed is not None and committed < steps
    resumed = run(kill_dir, "--resume")
    assert resumed["start_step"] == committed > 0
    # the same process kind on the same data: bit for bit
    assert resumed["losses"] == full["losses"][committed:]


# ------------------------------------------------------------- telemetry
def test_checkpoint_events_land_in_telemetry_plane(tmp_path):
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.framework.monitor import stats_report
    ev_path = tmp_path / "events.jsonl"
    obs.set_event_path(str(ev_path))
    obs.set_enabled(True)
    try:
        m = CheckpointManager(tmp_path / "ck", name="t_ckpt")
        m.save(3, {"a": torch.ones(64)})
        m.wait()
        m.restore()
        stats = stats_report()
        assert stats["ckpt_t_ckpt_saves_total"] == 1
        assert stats["ckpt_t_ckpt_commits_total"] == 1
        assert stats["ckpt_t_ckpt_restores_total"] == 1
        assert stats["ckpt_t_ckpt_last_bytes"] == 256
        events = [json.loads(ln) for ln in open(ev_path)]
        kinds = [e["kind"] for e in events]
        assert kinds.count("ckpt_save") == kinds.count("ckpt_commit") == \
            kinds.count("ckpt_restore") == 1
        commit = next(e for e in events if e["kind"] == "ckpt_commit")
        assert commit["step"] == 3 and commit["bytes"] == 256
        assert commit["commit_ms"] >= commit["bg_write_ms"] >= 0
    finally:
        obs.set_enabled(None)
        obs.set_event_path(None)


# ------------------------------------------- distributed.checkpoint module
def test_save_state_dict_roundtrip_sync_and_async(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "b": torch.arange(4, dtype=torch.bfloat16)}
    dckpt.save_state_dict(state, str(tmp_path / "s"))
    dckpt.save_state_dict(state, str(tmp_path / "a"), async_save=True)
    state["w"].add_(1.0)            # after the snapshot: not saved
    for sub in ("s", "a"):
        target = {"w": torch.zeros(3, 4),
                  "b": torch.zeros(4, dtype=torch.bfloat16)}
        dckpt.load_state_dict(target, str(tmp_path / sub))
        assert torch.equal(target["w"], torch.arange(12.0).reshape(3, 4))
        assert torch.equal(target["b"], torch.arange(4,
                                                     dtype=torch.bfloat16))


# ----------------------------------------------------- wait deadlines
def test_ckpt_manager_wait_timeout_names_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), name="t")
    release = threading.Event()
    mgr._thread = threading.Thread(target=release.wait, daemon=True)
    mgr._thread.start()
    mgr._inflight_step = 7
    with pytest.raises(TimeoutError, match="step 7"):
        mgr.wait(timeout=0.1)
    # the thread stays tracked: a later wait can still drain it
    assert mgr._thread is not None
    release.set()
    mgr.wait(timeout=5.0)
    assert mgr._thread is None


def test_module_wait_all_timeout_requeues_pending():
    class Slow:
        def __init__(self):
            self.release = threading.Event()

        def wait(self):
            self.release.wait()

    class Broken:
        def wait(self):
            raise OSError("disk full")

    slow = Slow()
    with dckpt._PENDING_LOCK:
        assert not dckpt._PENDING
        # a FAILED earlier write must not be swallowed by a later write's
        # timeout — the real durability loss chains through
        dckpt._PENDING.append(Broken())
        dckpt._PENDING.append(slow)
    with pytest.raises(TimeoutError, match="already FAILED") as ei:
        dckpt.wait_all(timeout=0.1)
    assert isinstance(ei.value.__cause__, OSError)
    with dckpt._PENDING_LOCK:
        assert dckpt._PENDING == [slow]
    slow.release.set()
    dckpt.wait_all(timeout=5.0)
    with dckpt._PENDING_LOCK:
        assert not dckpt._PENDING
