"""Serving the LMs: ``repro_torch.train.serve`` (``generate``,
``BatchedServer``) and ``python -m repro_torch.launch.serve`` against the
reference's, at the SMOKE configs on the CPU.

Sampling draws from a ``torch.Generator``, not JAX's keys, so tokens are
compared under greedy decoding (``temperature=0``); the server's grouping
and left padding are compared with its ``generate`` made greedy in both
packages.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_tf
from repro.train import serve as ref_serve
from repro_torch.configs import registry
from repro_torch.interop import transformer_params_from_reference
from repro_torch.models import transformer as tf
from repro_torch.train import serve

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ref_registry.LM_ARCHS)
BLOCKED = (
    "import sys, runpy\n"
    "for name in ('jax', 'networkx', 'repro'):\n"
    "    sys.modules[name] = None\n"
    "sys.argv = ['serve', *sys.argv[1:]]\n"
    "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
)


def both(arch):
    ref_cfg = ref_registry.arch_config(arch, smoke=True)
    cfg = registry.arch_config(arch, smoke=True)
    ref_p = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = transformer_params_from_reference(jax.tree.map(np.asarray, ref_p), cfg, "cpu")
    return ref_cfg, cfg, ref_p, p


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_gives_the_reference_tokens(arch):
    ref_cfg, cfg, ref_p, p = both(arch)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    want = ref_serve.generate(ref_p, jnp.asarray(prompt), ref_cfg, steps=8, temperature=0.0)
    got = serve.generate(p, prompt, cfg, steps=8, temperature=0.0)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-lite-16b"], ids=["gqa", "mla"])
def test_batched_server_groups_and_left_pads_as_the_reference(arch, monkeypatch):
    ref_cfg, cfg, ref_p, p = both(arch)
    monkeypatch.setattr(ref_serve, "generate",
                        functools.partial(ref_serve.generate, temperature=0.0))
    monkeypatch.setattr(serve, "generate", functools.partial(serve.generate, temperature=0.0))
    ref_server = ref_serve.BatchedServer(ref_p, ref_cfg, batch=2, max_len=64)
    server = serve.BatchedServer(p, cfg, batch=2, max_len=64)
    rng = np.random.default_rng(7)
    for _ in range(5):          # groups of 2, 2 and 1, each padded to its longest prompt
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(1, 9)))
        max_new = int(rng.integers(2, 6))
        assert server.submit(prompt, max_new) == ref_server.submit(prompt, max_new)
    want = ref_server.run(seed=3)
    assert server.run(seed=3) == want
    assert len({len(v) for v in want.values()}) > 1      # each cut to its own max_new


def test_sampling_is_seeded():
    cfg = registry.arch_config("granite-moe-1b-a400m", smoke=True)
    p = tf.init_params(cfg, device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (3, 4))
    a = serve.generate(p, prompt, cfg, steps=6, seed=1)
    assert torch.equal(a, serve.generate(p, prompt, cfg, steps=6, seed=1))
    assert not torch.equal(a, serve.generate(p, prompt, cfg, steps=6, seed=2))
    assert a.shape == (3, 6) and int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    runs = []
    for _ in range(2):
        server = serve.BatchedServer(p, cfg, batch=2, max_len=64)
        for row in prompt:
            server.submit(row, 5)
        runs.append(server.run(seed=4))
    assert runs[0] == runs[1] and sorted(runs[0]) == [0, 1, 2]


def test_submit_refuses_tokens_outside_the_vocabulary():
    cfg = registry.arch_config("qwen1.5-0.5b", smoke=True)
    server = serve.BatchedServer({}, cfg, batch=2, max_len=16)
    with pytest.raises(ValueError, match="vocab|lie in"):
        server.submit(np.array([1, cfg.vocab]), 4)
    with pytest.raises(ValueError, match="1-D"):
        server.submit(np.zeros((2, 2), np.int32), 4)
    assert not server.queue


def _port(*args):
    return subprocess.Popen([sys.executable, "-c", BLOCKED, *args], text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def _finish(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    return proc.returncode, out, err


def test_launcher_on_the_cpu_reports_what_the_reference_reports():
    common = ["--arch", "qwen1.5-0.5b", "--smoke", "--requests", "5", "--max-new", "6"]
    port = _port(*common, "--device", "cpu")
    ref = subprocess.Popen([sys.executable, "-m", "repro.launch.serve", *common], text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                "JAX_PLATFORMS": "cpu"})
    (rc, out, err), (ref_rc, ref_out, ref_err) = _finish(port), _finish(ref)
    assert rc == 0, err[-3000:]
    assert ref_rc == 0, ref_err[-3000:]
    got, want = json.loads(out), json.loads(ref_out)
    assert want.keys() <= got.keys() and got["device"] == "cpu"
    for key in ("arch", "requests", "generated_tokens"):
        assert got[key] == want[key], key
    assert got["generated_tokens"] == 5 * 6 and got["tok_per_s"] > 0


def test_launcher_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher runs on it")
    rc, out, err = _finish(_port("--arch", "qwen1.5-0.5b", "--smoke"))
    assert rc != 0 and out == ""
    assert "--device cpu" in err
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.init_params(registry.arch_config("qwen1.5-0.5b", smoke=True))
