"""The training substrate: optimizer, train steps, checkpoints and fault
tolerance of the port against ``repro``'s, on the CPU.

Inputs are made from seeds with numpy and handed to both packages.
Tolerances: 1e-6 on ``adamw_update``, ``clip_by_global_norm``,
``cosine_schedule`` and ``quantize_int8`` (one float32 update, sums over
leaves in another order); 1e-5 on params after three ``make_train_step``
steps at ``two_tower_retrieval.SMOKE`` and 1e-6 on their loss, global norm
and learning rate (relative: the in-batch softmax at temperature 0.05
makes losses near 5 and norms near 10).  The nine cases of
``tests/test_train_substrate.py`` are repeated on the port, the
transformer's resilient run as the two-tower model's.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

import repro.optim as ref_optim
import repro.train as ref_train
from repro.configs import two_tower_retrieval as ref_configs
from repro.data.recsys_stream import RecsysStream
from repro.models.recsys import two_tower as ref_tt
from repro.relational import embedding as ref_emb
from repro_torch.configs.two_tower_retrieval import SMOKE
from repro_torch.interop import train_state_from_reference, train_state_to_reference
from repro_torch.models.recsys import two_tower as tt
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_state_init,
    compressed_psum,
    cosine_schedule,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.relational import embedding
from repro_torch.train import (
    CheckpointManager,
    StragglerMonitor,
    TrainState,
    init_train_state,
    make_train_step,
    restore_pytree,
    run_resilient,
    save_pytree,
)
from repro_torch.train.fault_tolerance import is_device_fault

SCHEDULE = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
BATCH = 16


def _t(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _close_trees(got, want, tol):
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(got_leaves) == len(want_leaves)
    for path, g in got_leaves:
        np.testing.assert_allclose(np.asarray(g), np.asarray(want_leaves[path]),
                                   atol=tol, rtol=tol, err_msg=str(path))


def _tree(seed, shapes=(("w", (5, 3)), ("b", (3,)))):
    rng = np.random.default_rng(seed)
    return {"layer": {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes},
            "table": rng.standard_normal((7, 4)).astype(np.float32)}


def _stream(cfg=SMOKE, batch=BATCH):
    return RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields, cfg.item_fields,
                        cfg.field_hots, cfg.n_dense_feat, batch=batch, seed=0)


def _smoke_params(seed=0):
    return jax.tree.map(np.asarray, ref_tt.init_params(jax.random.PRNGKey(seed),
                                                       ref_configs.SMOKE))


# -- the optimizer against the reference ------------------------------------------


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(max_norm):
    params, ref_params = _t(_tree(0)), jax.tree.map(jnp.asarray, _tree(0))
    state, ref_state = adamw_init(params), ref_optim.adamw_init(ref_params)
    for step in range(3):
        grads = _tree(10 + step)
        lr = 0.05 / (step + 1)
        params, state, gnorm = adamw_update(params, _t(grads), state, lr,
                                            max_grad_norm=max_norm)
        ref_params, ref_state, ref_gnorm = ref_optim.adamw_update(
            ref_params, jax.tree.map(jnp.asarray, grads), ref_state, lr,
            max_grad_norm=max_norm)
        np.testing.assert_allclose(float(gnorm), float(ref_gnorm), rtol=1e-6)
    _close_trees(_np(params), ref_params, 1e-6)
    _close_trees(_np(state["mu"]), ref_state["mu"], 1e-6)
    _close_trees(_np(state["nu"]), ref_state["nu"], 1e-6)
    assert state["count"].dtype == torch.int32 and int(state["count"]) == int(ref_state["count"])


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(3)
    got, norm = clip_by_global_norm(_t(grads), max_norm)
    want, ref_norm = ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    _close_trees(_np(got), want, 1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 9_999, 20_000])
def test_cosine_schedule_matches_reference(step):
    for kw in ({}, dict(peak_lr=1.0, warmup_steps=10, total_steps=100, final_frac=0.1),
               SCHEDULE):
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(ref_optim.cosine_schedule(step, **kw)),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_matches_reference(seed):
    x = np.random.default_rng(seed).standard_normal((33, 17)).astype(np.float32) * (seed + 1)
    q, scale = quantize_int8(torch.tensor(x))
    ref_q, ref_scale = ref_optim.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_allclose(float(scale), float(ref_scale), rtol=1e-6)
    assert np.abs(q.numpy().astype(np.int32) - np.asarray(ref_q).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(dequantize_int8(q, scale).numpy(),
                               np.asarray(ref_optim.dequantize_int8(ref_q, ref_scale)),
                               atol=float(ref_scale) + 1e-6)
    assert (q.numpy() == np.asarray(ref_q)).mean() > 0.99


def test_compressed_psum_on_one_rank_keeps_the_residual(tmp_path):
    """On a group of one the sum is the rank's own int8-rounded gradient and
    the error buffer holds what the rounding dropped."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        grads = _t(_tree(4))
        err = compress_state_init(grads)
        out, err = compressed_psum(grads, err)
        for g, o, e in zip(tree_leaves(grads), tree_leaves(out), tree_leaves(err)):
            q, scale = quantize_int8(g)
            torch.testing.assert_close(o, dequantize_int8(q, scale), rtol=0, atol=0)
            torch.testing.assert_close(e, g - o, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


# -- the two-tower loss and train steps -------------------------------------------


def test_loss_and_gradients_match_reference():
    params = _smoke_params(0)
    batch = _stream().batch(0)
    ref_loss, ref_grads = jax.value_and_grad(ref_tt.loss)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch),
        ref_configs.SMOKE)
    from repro_torch.train.step import value_and_grad

    loss, grads = value_and_grad(tt.loss, _t(params), _t(batch), SMOKE)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # 1e-5 of each leaf's largest entry: the logits are divided by the
    # temperature 0.05, so gradients reach 20 and float32 sums in another
    # order differ in their last bits at that scale
    want = dict(jax.tree_util.tree_flatten_with_path(ref_grads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(_np(grads))[0]:
        scale = float(np.abs(want[path]).max())
        np.testing.assert_allclose(g, want[path], atol=1e-5 * scale, rtol=0, err_msg=str(path))


def test_embedding_bag_takes_torch_ops_under_autograd(monkeypatch):
    """The kernel (its plain version on the CPU) serves bags that need no
    gradient; under autograd the bag is a masked take plus a sum, and its
    gradient is the reference's."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((20, 6)).astype(np.float32)
    ids = rng.integers(-1, 20, size=(9, 4)).astype(np.int32)
    calls = []
    kernel = embedding.gather_sum
    monkeypatch.setattr(embedding, "gather_sum", lambda i, x: calls.append(1) or kernel(i, x))
    t = torch.tensor(table)
    embedding.embedding_bag(t, torch.tensor(ids))
    assert calls == [1]
    t.requires_grad_(True)
    with torch.no_grad():
        embedding.embedding_bag(t, torch.tensor(ids))
    assert calls == [1, 1]
    out = embedding.embedding_bag(t, torch.tensor(ids))
    assert calls == [1, 1]
    w = rng.standard_normal(out.shape).astype(np.float32)
    (out * torch.tensor(w)).sum().backward()
    ref_grad = jax.grad(lambda tb: jnp.sum(ref_emb.embedding_bag(tb, jnp.asarray(ids)) * w))(
        jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_grad), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    params = _smoke_params(1)
    ref_state = ref_train.init_train_state(jax.tree.map(jnp.asarray, params))
    state = train_state_from_reference(jax.tree.map(np.asarray, ref_state), "cpu")
    ref_step = ref_train.make_train_step(ref_tt.loss, ref_configs.SMOKE, accum=accum,
                                         donate=False, **SCHEDULE)
    step = make_train_step(tt.loss, SMOKE, accum=accum, **SCHEDULE)
    stream = _stream()
    for i in range(3):
        b = stream.batch(i)
        if accum > 1:
            b = {k: v.reshape((accum, -1) + v.shape[1:]) for k, v in b.items()}
        state, metrics = step(state, _t(b))
        ref_state, ref_metrics = ref_step(ref_state, jax.tree.map(jnp.asarray, b))
        assert metrics.keys() == ref_metrics.keys()
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    params, opt, step_no = train_state_to_reference(state)
    _close_trees(params, ref_state.params, 1e-5)
    _close_trees(opt, ref_state.opt, 1e-5)
    assert step_no.dtype == np.int32 and int(step_no) == int(ref_state.step) == 3


def test_train_state_crosses_both_ways():
    ref_state = ref_train.init_train_state(jax.tree.map(jnp.asarray, _smoke_params(2)))
    state = train_state_from_reference(jax.tree.map(np.asarray, ref_state), "cpu")
    assert isinstance(state, TrainState)
    assert state.opt.keys() == {"mu", "nu", "count"}
    back = ref_train.TrainState(*train_state_to_reference(state))
    assert jax.tree.structure(back) == jax.tree.structure(ref_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b))


# -- checkpoints across packages --------------------------------------------------


def _state_pair(seed):
    ref_state = ref_train.init_train_state(jax.tree.map(jnp.asarray, _smoke_params(seed)))
    ref_state = ref_state._replace(step=jnp.asarray(5, jnp.int32))
    return ref_state, train_state_from_reference(jax.tree.map(np.asarray, ref_state), "cpu")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _, state = _state_pair(3)
    for leaf in tree_leaves(state.opt["mu"]):
        leaf.add_(0.25)
    path = str(tmp_path / "port.npz")
    save_pytree(path, state, step=5)
    like = ref_train.init_train_state(jax.tree.map(jnp.asarray, _smoke_params(9)))
    restored, step = ref_train.restore_pytree(path, like)
    assert step == 5
    want = train_state_to_reference(state)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref_train.TrainState(*want))):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_state, _ = _state_pair(4)
    path = str(tmp_path / "ref.npz")
    ref_train.save_pytree(path, ref_state, step=5)
    like = init_train_state(tt.init_params(SMOKE, torch.Generator().manual_seed(1),
                                           device="cpu"))
    restored, step = restore_pytree(path, like)
    assert step == 5 and isinstance(restored, TrainState)
    for a, b in zip(jax.tree.leaves(ref_train.TrainState(*train_state_to_reference(restored))),
                    jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b))


def test_async_save_copies_before_the_next_step(tmp_path):
    """The port updates tensors in place: a save that returns before its
    write must already hold its own copy of every leaf."""
    w = torch.zeros(1 << 20)
    gate = threading.Event()
    real_savez = np.savez

    def slow_savez(*args, **kwargs):
        gate.wait(10)
        return real_savez(*args, **kwargs)

    np.savez = slow_savez
    try:
        writer = save_pytree(str(tmp_path / "ck.npz"), {"w": w}, step=1, blocking=False)
        w.add_(1.0)                        # the next step, while the writer waits
        gate.set()
        writer.join(10)
    finally:
        np.savez = real_savez
    assert not writer.is_alive()
    restored, _ = restore_pytree(str(tmp_path / "ck.npz"), {"w": w})
    assert float(restored["w"].abs().max()) == 0.0


# -- the reference's nine substrate cases, on the port ----------------------------


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        torch.sum((w - target) ** 2).backward()
        params, state, _ = adamw_update(params, {"w": w.grad}, state, lr=0.05,
                                        weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_cosine_schedule_shape():
    assert float(cosine_schedule(0, peak_lr=1.0, warmup_steps=10, total_steps=100)) == 0.0
    assert abs(float(cosine_schedule(10, peak_lr=1.0, warmup_steps=10, total_steps=100))
               - 1.0) < 1e-6
    end = float(cosine_schedule(100, peak_lr=1.0, warmup_steps=10, total_steps=100,
                                final_frac=0.1))
    assert abs(end - 0.1) < 1e-6


def test_int8_quantization_error_bounded():
    x = torch.tensor(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = quantize_int8(x)
    assert float((dequantize_int8(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-6


def test_checkpoint_roundtrip_nested(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.ones(4, dtype=torch.bfloat16), "d": [torch.zeros(2), torch.ones(1)]},
    }
    path = str(tmp_path / "ck.npz")
    save_pytree(path, tree, step=7)
    assert set(np.load(path).files) == {"a", "b/c", "b/d/0", "b/d/1", "__step__"}
    restored, step = restore_pytree(path, tree)
    assert step == 7
    for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
        assert x.dtype == y.dtype
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy())


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=2)
    tree = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.latest()[0] == 4
    assert len(mgr._steps()) <= 3          # keep + possibly in-flight


def _resilient(tmp_path, inject):
    stream = _stream()
    step = make_train_step(tt.loss, SMOKE, **SCHEDULE)
    mgr = CheckpointManager(str(tmp_path), save_every=3, keep=3)
    monitor = StragglerMonitor()
    return run_resilient(
        init_state_fn=lambda: init_train_state(
            tt.init_params(SMOKE, torch.Generator().manual_seed(0), device="cpu")),
        step_fn=step,
        data_fn=lambda i: {k: torch.tensor(v) for k, v in stream.batch(i).items()},
        manager=mgr,
        total_steps=8,
        inject_failure_at=inject,
        monitor=monitor,
    )


def test_resilient_training_survives_failure(tmp_path):
    state, history, restarts = _resilient(tmp_path / "a", inject=5)
    assert restarts == 1
    assert int(state.step) == 8
    clean, clean_history, clean_restarts = _resilient(tmp_path / "b", inject=None)
    assert clean_restarts == 0 and len(history) == len(clean_history) + 2
    for a, b in zip(tree_leaves(state.params), tree_leaves(clean.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=2.0)
    for i in range(10):
        mon.observe(i, 0.1)
    assert mon.observe(10, 0.5)
    assert len(mon.events) == 1


def test_elastic_restore_changes_placement(tmp_path):
    """A checkpoint restored onto another device than the tree it came from."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    path = str(tmp_path / "ck.npz")
    save_pytree(path, tree, step=1)
    like = {"w": torch.empty((4, 4), device="meta")}
    restored, _ = restore_pytree(path, like, device="cpu")
    assert restored["w"].device.type == "cpu"
    np.testing.assert_allclose(restored["w"].numpy(), tree["w"].numpy())
    assert restore_pytree(path, like)[0]["w"].device.type == "meta"


# -- device faults are not retried ---------------------------------------------


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 7.17 GiB"),
    torch.AcceleratorError("CUDA error: unspecified launch failure"),
    torch.distributed.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp, unhandled "
                                       "CUDA error"),
    RuntimeError("bitmm launch failed: cudaError 700"),
], ids=["runtime", "oom", "accelerator", "nccl", "kernel"])
def test_run_resilient_reraises_device_faults(tmp_path, error):
    """A CUDA error (here a raised stand-in) leaves the context unusable: it
    propagates at once, with no restore and no retry."""
    assert is_device_fault(error)
    inits = []

    def step_fn(state, batch):
        if int(state.step) == 2:
            raise error
        return state._replace(step=state.step + 1), {"loss": torch.tensor(0.0)}

    def init():
        inits.append(1)
        return init_train_state({"w": torch.zeros(3)})

    with pytest.raises(type(error)) as caught:
        run_resilient(init_state_fn=init, step_fn=step_fn, data_fn=lambda i: {},
                      manager=CheckpointManager(str(tmp_path), save_every=1),
                      total_steps=5)
    assert caught.value is error
    assert inits == [1]
    assert not is_device_fault(RuntimeError("injected node failure at step 3"))


@pytest.mark.parametrize("error", [
    RuntimeError("Expected all tensors to be on the same device, but found at least two "
                 "devices, cuda:0 and cpu!"),
    RuntimeError("Attempting to deserialize object on a CUDA device but "
                 "torch.cuda.is_available() is False."),
], ids=["wrong-device", "deserialize"])
def test_run_resilient_retries_host_errors_that_mention_cuda(tmp_path, error):
    """A host-side error from the step whose text mentions CUDA is not a
    device fault: the loop restores and retries as for any other failure."""
    assert not is_device_fault(error)
    raised = []

    def step_fn(state, batch):
        if int(state.step) == 2 and not raised:
            raised.append(1)
            raise error
        return state._replace(step=state.step + 1), {"loss": torch.tensor(0.0)}

    state, history, restarts = run_resilient(
        init_state_fn=lambda: init_train_state({"w": torch.zeros(3)}), step_fn=step_fn,
        data_fn=lambda i: {}, manager=CheckpointManager(str(tmp_path), save_every=1),
        total_steps=5)
    assert restarts == 1 and int(state.step) == 5 and len(history) == 5
