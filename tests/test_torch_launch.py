"""The launcher: ``python -m repro_torch.launch.train --arch datalog:<w>``
against ``python -m repro.launch.train`` on the same graph.

Both run as subprocesses, all at once from one module fixture: the port
with ``--device cpu`` and with JAX, networkx and ``repro`` blocked, the
reference on JAX's CPU.  Their JSON must agree on every key but the wall
time.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKLOADS = ("tc", "sg", "cc", "reach", "sssp")
GRAPH = ["--graph-n", "200", "--graph-p", "0.02", "--seed", "3"]
BLOCKED = (
    "import sys, runpy\n"
    "for name in ('jax', 'networkx', 'repro'):\n"
    "    sys.modules[name] = None\n"
    "sys.argv = ['train', *sys.argv[1:]]\n"
    "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
)


def _port(*args, **kw):
    return subprocess.Popen([sys.executable, "-c", BLOCKED, *args], text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                                 **kw})


def _finish(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("launch")
    ref_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    procs = {}
    for w in WORKLOADS:
        common = ["--arch", f"datalog:{w}", *GRAPH, "--ckpt-every", "4"]
        procs[w] = (
            _port(*common, "--device", "cpu", "--ckpt-dir", str(work / f"port_{w}")),
            subprocess.Popen([sys.executable, "-m", "repro.launch.train", *common,
                              "--ckpt-dir", str(work / f"ref_{w}")], env=ref_env,
                             text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        )
    out = {}
    for w, (port, ref) in procs.items():
        results = []
        for proc in (port, ref):
            rc, stdout, stderr = _finish(proc)
            assert rc == 0, stderr[-3000:]
            results.append(json.loads(stdout))
        out[w] = results
    return out


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cli_matches_reference(runs, workload):
    port, ref = runs[workload]
    assert port.keys() == ref.keys()
    for key in ref:
        if key != "seconds":
            assert port[key] == ref[key], key
    assert port["workload"] == workload and sum(port["output_sizes"].values()) > 0


def test_cli_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher runs on it")
    rc, _, err = _finish(_port("--arch", "datalog:tc", "--graph-n", "50"))
    assert rc != 0 and 'device="cpu"' in err


def test_language_model_training_waits_for_its_roadmap_item(tmp_path):
    """The roadmap item (A11, LM training) is done: ``--arch <lm> --smoke``
    trains through ``train_lm`` with JAX and ``repro`` blocked, and prints the
    reference's keys (``tests/test_torch_lm_train.py`` holds its numbers
    against the reference's launcher)."""
    rc, out, err = _finish(_port("--arch", "gemma-2b", "--smoke", "--steps", "2", "--batch",
                                 "2", "--seq", "8", "--device", "cpu", "--ckpt-dir",
                                 str(tmp_path)))
    assert rc == 0, err[-3000:]
    got = json.loads(out)
    assert list(got) == ["arch", "steps", "final_loss", "first_loss", "tokens", "tok_per_s",
                         "restarts", "straggler_events", "params"]
    assert got["arch"] == "gemma-smoke" and got["steps"] == 2 and got["tokens"] == 32
    assert got["restarts"] == 0 and got["first_loss"] > 0


def test_language_model_options_are_refused_for_datalog(tmp_path, capsys):
    """The language models' options parse with a Datalog arch and leave the
    run as it was, as the reference's parser has them (an option the parser
    does not know is still an error)."""
    from repro_torch.launch.train import main

    args = ["--arch", "datalog:tc", "--graph-n", "50", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    main(args)
    plain = json.loads(capsys.readouterr().out)
    main([*args, "--steps", "10", "--batch", "3", "--seq", "5", "--lr", "1e-3", "--smoke"])
    with_options = json.loads(capsys.readouterr().out)
    plain.pop("seconds"), with_options.pop("seconds")
    assert with_options == plain
    with pytest.raises(SystemExit) as exc:
        main([*args, "--epochs", "10"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --epochs 10" in capsys.readouterr().err


def test_coordinator_initialises_the_process_group(tmp_path):
    """``--coordinator`` joins a ``torch.distributed`` group (gloo on the CPU)
    before the run, as ``jax.distributed.initialize`` does in the reference."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = BLOCKED.replace(
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n",
        "from repro_torch.launch import train\n"
        "import torch.distributed as dist\n"
        "train.main(sys.argv[1:])\n"
        "print(dist.get_backend(), dist.get_world_size(), dist.get_rank())\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--arch", "datalog:tc", "--graph-n", "50",
         "--device", "cpu", "--ckpt-dir", str(tmp_path), "--coordinator", f"localhost:{port}",
         "--num-processes", "1", "--process-id", "0"],
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    rc, out, err = _finish(proc, timeout=120)
    assert rc == 0, err
    assert out.strip().splitlines()[-1] == "gloo 1 0"
