"""LM training: ``make_train_step(lm_loss)`` and ``launch.train``'s
``train_lm`` branch of the port against ``repro``'s, on the CPU.

Each case starts both packages from the reference's ``init_params`` weights
(``interop.transformer_params_from_reference``) and feeds them the same
``TokenStream`` batches; the reference's functions run under ``jax.jit``.
Tolerances: the port's gradients within 1e-5 of each leaf's largest entry
and the loss within 1e-5, both in float32; then the port's update is fed the
reference's gradients (Adam's lr · sign(g) would magnify float32 noise in a
gradient entry that cancels), and its loss, global norm and learning rate
equal the reference's within 1e-5 (relative), its params within 1e-5.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

import repro.train as ref_train
from repro.configs import registry as ref_registry
from repro.launch import train as ref_launch
from repro.models import transformer as ref_tf
from repro_torch.configs import registry
from repro_torch.data import TokenStream
from repro_torch.interop import (
    train_state_from_reference,
    train_state_to_reference,
    transformer_params_from_reference,
    transformer_params_to_reference,
)
from repro_torch.launch import train as launch
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import layers
from repro_torch.train import make_train_step
from repro_torch.train import step as train_step_mod

ARCHS = list(ref_registry.LM_ARCHS)
TOL = 1e-5
SCHEDULE = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 2, 12, 2
ref_grad = jax.jit(jax.grad(ref_tf.lm_loss), static_argnums=(2, 3))


def rel_close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err


def by_path(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("arch,remat", [(a, False) for a in ARCHS]
                         + [("granite-moe-1b-a400m", True), ("deepseek-v2-lite-16b", True)])
def test_train_steps_match_the_reference(arch, remat, monkeypatch):
    ref_cfg = ref_registry.arch_config(arch, smoke=True)
    cfg = registry.arch_config(arch, smoke=True)
    ref_state = ref_train.init_train_state(ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    state = train_state_from_reference(jax.tree.map(np.asarray, ref_state), "cpu")
    ref_step = ref_train.make_train_step(ref_tf.lm_loss, ref_cfg, donate=False, remat=remat,
                                         **SCHEDULE)
    step = make_train_step(tf.lm_loss, cfg, remat=remat, **SCHEDULE)
    stream = TokenStream(cfg.vocab, BATCH, SEQ, seed=1)
    real = train_step_mod.value_and_grad

    for i in range(STEPS):
        batch = stream.batch(i)
        ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        want = jax.tree.map(np.asarray, ref_grad(ref_state.params, ref_batch, ref_cfg, remat))

        def fed(*args, **kwargs):
            loss, grads = real(*args, **kwargs)
            got = by_path(transformer_params_to_reference(grads))
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
                rel_close(got[path], leaf)
            return loss, transformer_params_from_reference(want, cfg, "cpu")

        monkeypatch.setattr(train_step_mod, "value_and_grad", fed)
        state, metrics = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        ref_state, ref_metrics = ref_step(ref_state, ref_batch)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=TOL,
                                       err_msg=k)
    monkeypatch.undo()
    params, opt, step_no = train_state_to_reference(state)
    want_params = by_path(ref_state.params)
    moved = 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        want = np.asarray(want_params[path], np.float32)
        np.testing.assert_allclose(leaf, want, atol=TOL, rtol=0, err_msg=str(path))
    for a, b in zip(tree_leaves(state.params), jax.tree.leaves(
            jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)))):
        moved = max(moved, float(np.abs(a.numpy() - b).max()))
    assert moved > 1e-3 and int(step_no) == STEPS == int(opt["count"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"])
def test_remat_reads_the_group_sizes_again_on_recompute(arch):
    """Under ``remat`` the backward pass recomputes each MoE layer, reading
    its group sizes again (last layer first), and routes as the forward did."""
    cfg = registry.arch_config(arch, smoke=True)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in TokenStream(cfg.vocab, 2, 12).batch(0).items()}
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    for remat in (False, True):
        layers.ROUTED = routed = []
        try:
            train_step_mod.value_and_grad(tf.lm_loss, params, batch, cfg, remat=remat)
        finally:
            layers.ROUTED = None
        assert len(routed) == (2 if remat else 1) * n_moe
        if remat:
            assert routed[n_moe:] == routed[:n_moe][::-1]


def _run_launcher(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    main()
    return json.loads(capsys.readouterr().out)


def test_launcher_trains_as_the_reference(tmp_path, monkeypatch, capsys):
    """``launch.train --smoke --steps 2 --device cpu`` against the reference's
    launcher in this process, the port's ``init_params`` handing out the
    reference's weights for the seed: the same keys, the reference's
    ``first_loss`` within 1e-5, no restart."""
    arch = "granite-moe-1b-a400m"
    args = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq", "16"]
    want = _run_launcher(ref_launch.main, [*args, "--ckpt-dir", str(tmp_path / "ref")],
                         monkeypatch, capsys)
    cfg = registry.arch_config(arch, smoke=True)
    ref_params = jax.tree.map(np.asarray, ref_tf.init_params(
        jax.random.PRNGKey(0), ref_registry.arch_config(arch, smoke=True)))
    monkeypatch.setattr(tf, "init_params", lambda c, generator, device: (
        transformer_params_from_reference(ref_params, c, device)))
    got = _run_launcher(lambda: launch.main(sys.argv[1:]),
                        [*args, "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")],
                        monkeypatch, capsys)
    assert list(got) == list(want)
    for key in ("arch", "steps", "tokens", "restarts", "straggler_events", "params"):
        assert got[key] == want[key], key
    assert abs(got["first_loss"] - want["first_loss"]) <= TOL * abs(want["first_loss"])
    assert abs(got["final_loss"] - want["final_loss"]) <= 1e-3 * abs(want["final_loss"])
    assert got["restarts"] == 0 and cfg.name == got["arch"]


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    """A second run in the same ``--ckpt-dir`` restores the first run's last
    checkpoint and runs no step."""
    args = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    launch.main(args)
    first = json.loads(capsys.readouterr().out)
    launch.main(args)
    again = json.loads(capsys.readouterr().out)
    assert first["final_loss"] is not None and np.isfinite(first["final_loss"])
    assert again["first_loss"] is None and again["restarts"] == 0


def test_launcher_refuses_other_archs():
    with pytest.raises(SystemExit, match="not a language model"):
        launch.main(["--arch", "gcn-cora", "--device", "cpu"])


def test_launcher_trains_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher trains on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch.main(["--arch", "gemma-2b", "--smoke", "--steps", "1", "--ckpt-dir",
                     str(tmp_path)])
