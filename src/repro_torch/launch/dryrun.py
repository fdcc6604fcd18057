"""Multi-pod dry run: every (arch × shape × mesh) cell traced for one rank.

The reference lowers and compiles each cell with XLA on 512 placeholder
devices.  Here one process joins a ``"fake"`` process group as rank 0 of
the production world (256 ranks as a (16, 16) mesh, 512 as (2, 16, 16)),
cuts each cell's arguments into this rank's blocks as fake tensors (shapes
and dtypes only, as ``distributed.place`` would cut them) and runs the
cell's step on them under ``FakeTensorMode``: every op, collective and
kernel wrapper of the real step runs, and nothing is allocated, computed or
sent.  On the card (``--device cuda``, the default) the fake tensors are
CUDA tensors, so the traced path is the card's, kernel routes included;
``--device cpu`` traces the CPU path.  MoE layers run their expert-parallel
form (``distributed.mesh_context``).  Per cell it records

  * ``argument_size_in_bytes``: this rank's blocks;
  * ``temp_size_in_bytes``: the step's peak of live storage bytes, counted
    at the dispatcher, less the arguments; ``output_size_in_bytes``: the
    distinct storages of the result (an update in place aliases the
    arguments);
  * ``flops`` (``FlopCounterMode``'s formulas: matrix products, convolutions
    and attention; the hand-written kernels are not counted) beside the
    registry's ``model_flops``;
  * ``collectives``: this rank's output bytes by kind
    (``distributed.collective_bytes``);
  * ``kernel_calls``: the hand-written kernels the step reached
    (their wrappers' ``fake_calls``);
  * ``trace_s`` and ``total_s``.

A prefill cell is traced with its stack cut to 2 and 3 layers and every
count extrapolated linearly to the full depth (``traced_in_depth``; its
``depths_traced`` says so; see ``EXTRAPOLATED``).  Every other cell is
traced whole.

XLA's ``hlo_bytes`` has no counterpart: an eager step fuses nothing.  A
host read of a fake tensor has no value; the steps that read one (MoE group
sizes, AdamW's count, a decode position) take the reference's static shapes
instead (see ``layers._host_sizes``).  Rank 0 is traced and stands for
every rank: ``place`` cuts a dimension into equal blocks or raises, so the
blocks' shapes are the same on every rank (padded edges, -1, sit in the
last ranks' blocks: they change values, not shapes).

Results stream into ``results/dryrun_torch.json`` (one record per cell) and
an interrupted sweep resumes where it left off.  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--mesh single|multi|both]
        [--arch A] [--shape S] [--out results/dryrun_torch.json] [--refresh]
        [--device cuda|cpu]

The default process group is per process, so the sweep owns its process.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import registry
from repro_torch.distributed import dp_axes_of, mesh_context, place, traffic
from repro_torch.distributed.mesh import mesh_device
from repro_torch.kernels import bitmm, gather_sum
from repro_torch.launch.mesh import make_production_mesh, production_shape

MESHES = {"single": ("single-pod-16x16", False), "multi": ("multi-pod-2x16x16", True)}
TC_N = 81920                  # the PBME TC bonus row's vertices
DONE = ("ok", "skip", "bonus-ok")
#: steps traced at two cut depths and extrapolated (``traced_in_depth``): a
#: prefill at 32k walks 2048 attention block pairs a layer, about 25 s of host
#: time a layer on fake tensors, so a full-depth trace would take some 12
#: minutes a cell; every other step is traced whole, in seconds
EXTRAPOLATED = ("prefill",)
DEPTHS = (2, 3)
KERNELS = {"gather_sum": gather_sum.gather_sum, "bitmm": bitmm.bitmm,
           "bitmm_fused_delta": bitmm.bitmm_fused_delta}


class StepTally(TorchDispatchMode):
    """One pass over a step's ops: the live bytes of the storages that ops
    return and their peak (a storage counts from the op that first returns
    it until it is freed), the FLOPs of the products (``FlopCounterMode``'s
    formulas) and the collective bytes (``distributed.collective_bytes``'s
    count).  One mode and not three: the trace's time is per op."""

    def __init__(self, tensors=()):
        super().__init__()
        self.live = self.peak = 0
        self.flops = 0
        self.collectives: dict[str, int] = defaultdict(int)
        self._refs: dict[int, weakref.ref] = {}
        for t in tensors:
            self.track(t)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(st, functools.partial(self._freed, key, nbytes))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int, nbytes: int, _ref) -> None:
        del self._refs[key]
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        traffic.count(self.collectives, func, args)
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def fake_blocks(args, shardings, fake: FakeTensorMode, device):
    """This rank's block of every meta argument, as a fresh fake tensor."""
    with fake:
        whole = tree_map(
            lambda x: None if x is None else torch.empty(x.shape, dtype=x.dtype, device=device),
            args)
        return tree_map(lambda b: None if b is None else torch.empty_like(b),
                        place(whole, shardings))


def trace(fn, blocks, fake: FakeTensorMode, mesh) -> dict:
    """Run ``fn(*blocks)`` on fake tensors: bytes, FLOPs, collectives, kernels."""
    args = [t for t in tree_leaves(blocks) if isinstance(t, torch.Tensor)]
    arg_bytes = storage_bytes(args)
    before = {name: k.fake_calls for name, k in KERNELS.items()}
    tally = StepTally(args)
    t0 = time.time()
    with fake, mesh_context(mesh, dp_axes_of(mesh)), tally:
        out = fn(*blocks)
    trace_s = time.time() - t0
    calls = {name: k.fake_calls - before[name] for name, k in KERNELS.items()}
    return {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": storage_bytes(out),
        "temp_size_in_bytes": tally.peak - arg_bytes,
        "flops": float(tally.flops),
        "collectives": dict(tally.collectives),
        "kernel_calls": {name: n for name, n in calls.items() if n},
        "trace_s": round(trace_s, 1),
    }


def traced_in_depth(arch: str, shape: str, mesh, depth: int) -> dict:
    """An LM cell traced with its stack cut to each of ``DEPTHS`` layers,
    every count extrapolated linearly to ``depth`` layers.  Each layer adds
    the same weights, cache, work and traffic; the weights and the cache are
    there before the first layer runs, so the live bytes while a layer runs
    are the same for every layer but the first (which finds no previous
    layer's keys and values still held) and the peak grows by the same step
    from the second layer on: hence depths 2 and 3."""
    (lo, a), (hi, b) = ((d, _traced_cut(arch, shape, mesh, d)) for d in DEPTHS)

    def at_depth(x, y):
        return x + (y - x) * (depth - lo) // (hi - lo)

    rec = {key: at_depth(a[key], b[key])
           for key in ("output_size_in_bytes", "temp_size_in_bytes", "flops")}
    for key in ("collectives", "kernel_calls"):
        rec[key] = {k: at_depth(a[key].get(k, 0), b[key].get(k, 0))
                    for k in {**a[key], **b[key]}}
    rec["trace_s"] = round(a["trace_s"] + b["trace_s"], 1)
    rec["depths_traced"] = list(DEPTHS)
    return rec


def _traced_cut(arch: str, shape: str, mesh, layers: int) -> dict:
    cell = registry.build_lm_cell(arch, shape, mesh, layers=layers)
    fake = FakeTensorMode()
    return trace(cell.fn, fake_blocks(cell.args, cell.in_shardings, fake, mesh_device(mesh)),
                 fake, mesh)


def _fail(rec: dict, e: Exception) -> None:
    rec["status"] = "FAIL"
    rec["error"] = f"{type(e).__name__}: {str(e)[:500]}"
    rec["traceback"] = traceback.format_exc()[-2000:]


def run_cell(arch: str, shape: str, mesh, mesh_name: str) -> dict:
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "devices": mesh.size(),
           "status": "?"}
    t0 = time.time()
    try:
        cell = registry.build_cell(arch, shape, mesh)
        rec.update(step=cell.step, note=cell.note, model_flops=cell.model_flops)
        if cell.skip and not cell.bonus:
            rec["status"] = "skip"
            rec["skip_reason"] = cell.skip
            return rec
        if cell.skip:
            rec["skip_reason"] = cell.skip
            rec["bonus"] = True
        fake = FakeTensorMode()
        blocks = fake_blocks(cell.args, cell.in_shardings, fake, mesh_device(mesh))
        cfg = registry.arch_config(arch) if cell.kind == "lm" else None
        depth = cfg.n_layers - cfg.n_dense_prefix if cfg else 0
        if cell.step in EXTRAPOLATED and depth > max(DEPTHS):
            rec.update(traced_in_depth(arch, shape, mesh, depth))
            rec["argument_size_in_bytes"] = storage_bytes(blocks)
        else:
            rec.update(trace(cell.fn, blocks, fake, mesh))
        rec["status"] = "ok" if not cell.skip else "bonus-ok"
    except Exception as e:  # a failing cell is a bug: record it loudly
        _fail(rec, e)
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def run_tc_step(mesh, mesh_name: str) -> dict:
    """The paper-native bonus row: one sharded PBME TC step at n = TC_N."""
    from repro_torch.core.distributed import lower_tc_step

    rec = {"arch": "datalog-tc-pbme", "shape": "g80k", "mesh": mesh_name,
           "devices": mesh.size(), "status": "?"}
    t0 = time.time()
    try:
        row_axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
        step, args = lower_tc_step(mesh, TC_N, row_axes=row_axes)
        rec.update(trace(step, args, args[0].fake_mode, mesh))
        rec["model_flops"] = 2.0 * TC_N ** 3 / 32      # one boolean product on n×n bits
        rec["status"] = "ok"
    except Exception as e:
        _fail(rec, e)
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def load_results(path: str) -> dict:
    try:
        with open(path) as f:
            return {tuple(k.split("|")): v for k, v in json.load(f).items()}
    except (OSError, json.JSONDecodeError):
        return {}


def save_results(path: str, results: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"|".join(k): v for k, v in results.items()}, f, indent=1)


def fake_world(size: int) -> None:
    """Join a ``"fake"`` process group as rank 0 of ``size`` ranks: its
    collectives return at once and send nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def sweep(results: dict, out: str, mesh_name: str, mesh, cells, datalog: bool) -> None:
    for arch, shape in cells:
        key = (mesh_name, arch, shape)
        if key in results and results[key]["status"] in DONE:
            continue
        print(f"[dryrun] {mesh_name} {arch} × {shape} ...", flush=True)
        rec = run_cell(arch, shape, mesh, mesh_name)
        results[key] = rec
        save_results(out, results)
        print(f"  -> {rec['status']}"
              + (f" ({rec.get('error', '')[:120]})" if rec["status"] == "FAIL" else "")
              + f" [{rec.get('total_s', 0)}s]", flush=True)

    if datalog:
        key = (mesh_name, "datalog-tc-pbme", "g80k")
        if key not in results or results[key]["status"] == "FAIL":
            print(f"[dryrun] {mesh_name} datalog-tc-pbme × g80k ...", flush=True)
            rec = run_tc_step(mesh, mesh_name)
            results[key] = rec
            save_results(out, results)
            print(f"  -> {rec['status']} [{rec['total_s']}s]", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--refresh", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    results = {} if args.refresh else load_results(args.out)
    cells = registry.all_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    for which in (("single", "multi") if args.mesh == "both" else (args.mesh,)):
        mesh_name, multi_pod = MESHES[which]
        shape, _ = production_shape(multi_pod)
        fake_world(math.prod(shape))
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device=args.device)
            sweep(results, args.out, mesh_name, mesh, cells, datalog=not args.arch)
        finally:
            dist.destroy_process_group()

    n_ok = sum(1 for r in results.values() if r["status"] in ("ok", "bonus-ok"))
    n_skip = sum(1 for r in results.values() if r["status"] == "skip")
    n_fail = sum(1 for r in results.values() if r["status"] == "FAIL")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} FAIL -> {args.out}")


if __name__ == "__main__":
    main()
