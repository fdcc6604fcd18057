#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    PYTHONPATH=src python3 chip_smoke.py

Phases, one output line each:

1. device  — ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build   — compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``;
3. kernels — each hand-written kernel against its plain PyTorch version, bit
   for bit, at the test shapes and at the main path's shape (n = 10000:
   ``int32[10000, 313]`` operands; A sparse as the arc, mixed — empty,
   sparse and dense 1024-bit K stages in turn — and dense), with median times
   of kernel, plain version and the library yardstick, and the least time
   the card could take; and ``bitmm`` at the serving increments' shapes
   (M ∈ {1, 7, 128, 129, 1000} rows against the n = 10000 arc, K ∈ {1, 31,
   33, 1024, 10000} at M = n), each with its ms and bound;
4. tc / 5. sg — the main path: ``Engine.run`` on TC and SG over the paper's
   G10K graph (``gnp_graph(10000, p=0.001, seed=1)``) through the PBME
   kernels.  Launch counts are set to 0 just before and read just after, and
   each fixpoint must equal the one the plain fixpoint loop computes on the card;
   a separate run of the fixpoint loop alone gives ``fixpoint_seconds`` and
   one more, with CUDA events around each product, ``per_launch`` (ms, A's
   density and the bound of each launch);
6. tuple   — the tuple and dense paths (CSDA, Andersen, CC, REACH, SSSP at
   the benchmarks' largest sizes) on the card against the same port on the
   CPU, bit for bit;
6b. serve  — the serving layer (``repro_torch.serve_datalog``), one line per
   workload: each is materialized at 99 % of its EDB, one warm-up batch
   applied, then a 1 % batch through ``apply_txn`` (as
   ``benchmarks/bench_serve_datalog.py`` does), held bit for bit against a
   from-scratch ``Engine.run`` of the final EDB: ``serve_tc_pbme`` and
   ``serve_sg_pbme`` (``gnp_graph(10000, p=0.00015, seed=1)``, mode
   ``bitmatrix``: the increments run ``bitmm`` at row-compacted shapes, M =
   k < n and, in SG's sandwich, K = k), ``serve_tc_pbme_delete`` (G10K, a
   1 % delete: mode ``full``, the fused kernel recomputes 10^8 facts, diffed
   on the card), ``serve_tc_dred`` (``gnp_graph(1024, p=0.003, seed=0)``,
   tuple backend, a 1 % delete: DRed), ``serve_csda`` (a 1 % insert, mode
   ``delta``), ``serve_txn`` (the benchmark's two-relation transaction,
   once as one transaction and once as two: one epoch against two) and
   ``serve_reads`` (point queries through ``DatalogServer``, eight in
   flight, each timed from submission to reply: 512 with no update in
   flight, then while the writer thread inserts and deletes a 1 % batch in
   turn until 400 reads have overlapped it; the answers after the last
   insert publishes must be exact);
6d. serve_demand — on-demand point queries (``submit_query(...,
   on_demand=True)``) against a fresh full materialization plus the same
   selections, as ``benchmarks/bench_serve_datalog.py``'s ``_bench_demand``
   measures them, one line per case: ``serve_demand_tc`` (300 disjoint
   chains of 60 nodes, ``tc(src=0)`` and ``tc(src=60)``, tuple backend),
   ``serve_demand_csda`` (``csda_facts(3000, seed=0)``, absence checks on
   the first 4 nodes with no ``null`` fact) and ``serve_demand_g10k`` (TC on
   G10K through the PBME kernels, 4 point queries whose magic-set slices
   of 10^4 rows run on the tuple operators, then a 1 % insert into the base
   through the server and one more query, which must respecialize); each
   with both arms' seconds, the specialize seconds, the
   ``datalog_demand_*`` counts, the answer sizes and ``exact`` (every
   demanded answer equal to the full selection bit for bit);
6c. durability, run last, after phase 13, so that its gigabyte of files and
   its pinned host buffers are not around the earlier phases' timings —
   ``repro_torch.persist`` and warm restore, every root under
   one temporary directory (removed at the end), each result held bit for
   bit against the live instance's last epoch and a from-scratch
   ``Engine.run`` of the final EDB, with seconds, bytes and GB/s:
   ``durable_tc_pbme`` (the ``serve_tc_pbme`` graph: the baseline snapshot
   of ``DatalogServer(durability=...)``, a 1 % insert and ``checkpoint_now``,
   a WAL tail of a 1 % insert and a 1 % delete, then
   ``MaterializedInstance.restore`` split into the snapshot load and the
   replay, whose ``bitmm`` and ``bitmm_fused_delta`` launches must both be
   > 0, and one more 1 % insert on the restored instance),
   ``durable_g10k`` (TC on G10K, 10^8 facts: baseline and restore with the
   packed matrices loaded, not re-packed; 512 point reads idle and 512
   while ``checkpoint_now`` writes on another thread, submit to reply),
   ``engine_resume`` (CSDA 3000 on the tuple path with ``checkpoint_every=16``,
   then a fresh engine with ``resume_from``: equal rows, equal iterations
   after the resume point) and ``scenario_crash`` (a crash while shedding,
   restored exactly, and the burst scenario through
   ``repro_torch.loadgen``);
7. gather_sum — the gather-sum kernel against its plain version at
   ``test_gather_sum_sweep``'s shapes and on repeat-heavy ids (one row
   everywhere; more repeated rows than a tile's stage holds, in column
   slices; a NaN bag among repeats), float32 within 1e-5, bfloat16 within
   2e-2; and at the two-tower path's shapes over the FULL user and item
   tables (``RecsysStream(seed=0)``'s batch of 262,144: every field of a
   table in one call, ``idx [1048576, 8]`` and ``[524288, 8]``, and field 0
   alone, ``[262144, 8]``), each with lookups, distinct rows, the share of
   lookups that repeat a row, median times of kernel, plain version and
   ``F.embedding_bag``, the bound and the kernel's share of it;
8. recsys_serve — the two-tower model at ``two_tower_retrieval.FULL``
   (5e6 + 2e6 rows of 256 float32, TF32 off): ``serve_scores`` at batch 512
   (``serve_p99``, 50 requests: median and p99) and 262,144 (``serve_bulk``,
   rows/s), 2 gather-sum launches per call (one per table), scores within
   1e-4 of the same model on the card with its bags made by the plain
   version, and where the time goes;
9. recsys_retrieval — a 1,000,000-item corpus embedded with ``item_tower``,
   then ``retrieval_scores`` for one query at top_k = 100 (one launch per
   call and per corpus chunk), held against the plain-bag version: scores
   within 1e-4, indices equal wherever neighbouring reference scores differ
   by more than 1e-4;
10. sharded_tc — one NCCL rank (a ``file://`` store in a temporary
   directory) as a (1, 1) ``("data", "model")`` mesh: ``tc_fixpoint_sharded``
   at G10K in its three schedules (allgather and rows1d run ``bitmm`` on
   each rank's rows; psum a float product and a reduce-scatter), each
   assembled M equal to ``tc_fixpoint``'s words bit for bit with the same
   iterations, with seconds and the collectives' bytes per iteration;
11. train_recsys — ``make_train_step`` (accum 1 and 2) and
   ``make_compressed_dp_step`` on the card against three steps on the CPU at
   ``two_tower_retrieval.SMOKE`` and a learning rate of 1e-2, the card's
   step fed the CPU's gradients (its own within 1e-5 of each leaf's
   largest entry; params, mu and nu within 1e-6), then at FULL (7.17 GB of tables, batch 512) five steps of
   ``make_train_step`` and three of ``make_compressed_dp_step`` over the
   mesh: step ms, samples/s, the optimizer's share (CUDA events), peak
   memory; losses finite and no gather-sum launch (training bags are torch
   ops);
12. train_resilient — ``run_resilient`` at SMOKE with a failure injected at
   step 3 (one restart, params within 1e-5 of a clean run), checkpoints
   with the reference's npz keys, the last restored onto the card;
13. launch_datalog — ``python -m repro_torch.launch.train --arch
   datalog:tc --graph-n 1000`` as a subprocess, its sizes and iterations
   equal to ``Engine.run``'s in this process;
14. lm_smoke — the five transformer LMs (``repro_torch.models.transformer``)
   at SMOKE in float32, weights drawn once on the CPU and copied to the
   card: prefill, 8 decode steps, ``forward`` and greedy ``generate`` on the
   card against the CPU (within 1e-4 of the logits' largest value, tokens
   equal), and decode against ``forward``;
15. lm_serve_full — qwen2-7b (GQA, qkv bias, dense SwiGLU) and
   deepseek-v2-lite-16b (MLA with absorbed decode, MoE top-6 of 64 with 2
   shared experts, a dense first layer) at FULL width in bf16, one line each:
   8 requests through ``BatchedServer`` (batch 4, 16 new tokens), prefill
   and decode-step times (CUDA events), the decode step's device profile
   (busy share, device events and host synchronisations per step), its
   routed experts per MoE layer and its bound, peak memory, and 8 decode
   steps against ``forward`` at the same positions (within 5e-2 of the
   logits' largest value);
16. launch_serve — ``python -m repro_torch.launch.serve --arch qwen1.5-0.5b
   --requests 8`` as a subprocess, on the card by default;
17. lm_train_smoke / gnn_smoke — the five LMs (``lm_loss(remat=True)``) and
   the four GNNs (padded graph batches) at SMOKE in float32:
   ``make_train_step`` on the card against the CPU, three steps, the card's
   gradients within 1e-5 of each leaf's largest entry, then its update fed
   the CPU's gradients (params, mu and nu within 1e-6);
18. lm_train_full — granite-moe-1b-a400m at FULL (bf16 parameters, float32
   moments, 1.33e9 parameters) on the registry's train_4k sequences of 4096
   tokens at batch 4 (of its 256: what one card holds), ``lm_loss(remat=True)``:
   step ms (CUDA events) and tok/s against ``_lm_train_flops`` at the bf16
   tensor-core rate, the device's busy share and host syncs per step, the
   experts each layer routed to (the backward's recompute must route alike),
   peak memory, finite losses and gradient norms;
19. launch_train — ``python -m repro_torch.launch.train --arch qwen1.5-0.5b
   --steps 4`` as a subprocess (FULL, batch 8, sequence 256, on the card by
   default): the reference's JSON, no restart;
20. gnn_train_full — the four GNNs at FULL width on the largest registry
   shape one card holds: gcn-cora on ogb_products (2,449,029 nodes,
   61,859,140 edges), meshgraphnet and graphcast on minibatch_lg (1024 seeds
   sampled at fanouts 15, 10 by ``NeighborSampler`` on the card from that
   graph's CSR, flattened to 169,984 nodes and 168,960 edges; the sampler's
   ms), schnet on molecule: step ms against a bound, peak memory, finite
   losses.
21. sharded_lm — the sharded forms on one NCCL rank as a (1, 1) ``("data",
   "model")`` mesh: granite-moe-1b-a400m at FULL width (as phase 18)
   through ``make_sharded_train_step`` under ``mesh_context``, its state and
   batch cut by ``distributed.place``, the MoE through the expert-parallel
   form (every call counted): 1 warm and 3 timed steps, the first loss
   against the unsharded loss of the same parameters and batch; then
   deepseek-v2-lite-16b at FULL, ``forward`` of [4, 2048] under the mesh
   against the same without it (within 5e-2 of the logits' largest
   value); the routed experts of both;
22. halo_gcn — gcn-cora at FULL width through ``loss_halo`` on a ring of
   one (halo 512, senders offset by the halo) on the ring lattice of the
   ogb_products-sized graph of phase 20 (its 25 · 2,449,029 lattice edges;
   the reference's halo form normalises both ends by the receiver's degree,
   which is GCN's where all degrees are equal): train steps against
   ``gcn.loss``'s on the same graph, the loss within 1e-5, the gradients
   within 1e-4 (with ``gcn.loss``'s own run-to-run spread beside them);
23. cells — ``configs.registry.build_cell`` for every ``all_cells()`` entry on
   that mesh (arguments on ``meta``, nothing allocated): counts, skip
   reasons, MODEL_FLOPS and argument bytes; then one cell of each kind whose
   arguments one card holds, run on arguments made from ``SEED``
   (gemma-2b long_500k's bonus decode step, gcn-cora full_graph_sm's train
   step, two-tower serve_p99's scores), each against the plain function;
   ``sharding_launches`` counts each kernel's launches in phases 21-23.
24. dryrun — ``python -m repro_torch.launch.dryrun --mesh single`` as
   processes side by side (rank 0 of a fake world of 256 as the (16, 16)
   production mesh, the steps run on fake CUDA tensors): qwen2-7b
   prefill_32k, granite-moe-1b-a400m train_4k (expert-parallel MoE),
   deepseek-v2-lite-16b decode_32k, gcn-cora ogb_products, two-tower
   serve_p99 and train_batch, and the PBME TC bonus row (n = 81,920), every
   record ``ok`` or ``bonus-ok``, each with per-rank argument, temp and peak
   bytes beside the card's ``total_memory``, FLOPs, collective bytes and the
   kernels' shape-only calls (the TC step's ``bitmm``, whose scratch size
   must equal the kernel's); then RUN_CELLS traced on a fake world of one,
   arguments + temp within ``DRYRUN_TOL`` of phase 23's warm call's own
   peak plus its blocks.  No real tensor may take a wrapper's shape-only
   branch (``fake_calls`` 0 in this process).

Then a ``kernels`` JSON line (``launches``: each kernel's count on its main
path — TC and SG at G10K for ``bitmm`` and ``bitmm_fused_delta``, phases 8
and 9 for ``gather_sum``, whose times are the item table's at the main
path's shape, with every table and shape of phase 7 under ``tables``;
``serve_launches``: the timed serving batches of phase 6b;
``durable_launches``: the durability path's own work in phase 6c — writes
through a durable server, restores with their replay, writes on restored
instances, checkpointed and resumed engine runs — and not the from-scratch
references or the live instances built to compare with;
``sharded_launches``: phase 10's three sharded fixpoints; ``lm_launches``:
phases 14-16, ``train_launches``: phases 17-20 and ``sharding_launches``:
phases 21-23, which must be 0, as no kernel of the repo lies on the LM or
GNN path and the sharded recsys scores take torch ops; ``dryrun_fake_calls``:
the shape-only calls in phase 24's traced steps), the card's name
and power limit, and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; so does a machine without CUDA.
Every instance is admitted through the static analyzer's rewrites
(``repro_torch.analysis``), the serving layer's default.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# bitmm runs single-bit mma.sync (AND + POPC), whose rate NVIDIA does not
# publish: tools/mma_rates.py measured 5.2e15 bit multiply-accumulates a second
# on an H100 80GB HBM3 at 700 W, two operations each
B1_OPS_PER_S = 2 * 5.20191304247123e15
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
G10K = 10_000
REPS = 20
# the two-tower cells of configs/registry.py: serve_p99, serve_bulk, retrieval_cand
P99_BATCH, P99_CALLS = 512, 50
BULK_BATCH, BULK_REPS = 262_144, 5
CORPUS, TOP_K, QUERY_CALLS = 1_000_000, 100, 20
GATHER_SWEEP = [(8, 3, 20, 128), (16, 7, 50, 256), (4, 1, 5, 384),   # test_gather_sum_sweep
                (9, 5, 30, 99), (5, 40, 64, 36)]                      # the scalar path
GATHER_REPEATS = ("one_id", "over_stage", "nan_among_repeats")       # repeat_case
SCORE_TOL = 1e-4
# bitmm shapes held bit for bit against the plain version: multiples of none of
# the kernel's tiles (128 rows, 256 columns, 1024-bit K stages), or one past one
EXACT_SHAPES = [(128, 128, 128), (130, 70, 200), (64, 33, 97), (1, 1, 1), (300, 1000, 4100),
                (129, 257, 8193)]
# the serving increments' shapes: M frontier rows against the n x n arc, and
# the sandwich product's K = k (a partial 128-row block, K off the 32-bit
# word and the 1024-bit stage)
SERVE_M = (1, 7, 128, 129, 1000)
SERVE_K = (1, 31, 33, 1024, 10_000)
# the serving workloads' graphs (benchmarks/bench_serve_datalog.py sizes,
# and a sparse n = 10000 graph whose TC closure grows under a 1 % insert)
SERVE_SPARSE = dict(n=10_000, p=0.00015, seed=1)
SERVE_DRED = dict(n=1024, p=0.003, seed=0)
# serve_reads: point queries on READ_QUERIES sources, READ_BATCH at a time;
# READ_IDLE with no update in flight, then insert/delete rounds (at most
# READ_ROUNDS) until READ_OVERLAP reads have overlapped the writer
READ_QUERIES, READ_BATCH, READ_IDLE = 64, 8, 512
READ_OVERLAP, READ_ROUNDS = 400, 15                  # odd: the last round inserts
# phases 14-16, the transformer LMs
LM_TOL = 1e-4          # SMOKE, float32: card against CPU, of the logits' largest |value|
LM_FULL_TOL = 5e-2     # FULL, bfloat16: decode against forward, of the logits' largest |value|
LM_FULL_ARCHS = ("qwen2-7b", "deepseek-v2-lite-16b")
LM_REQUESTS, LM_BATCH, LM_MAX_NEW = 8, 4, 16     # launch.serve's defaults
LM_PROMPT, LM_DECODE_STEPS = 16, 8
# (prompt tokens, batch) of the long-context prefills at FULL, each followed by
# decode steps over its cache; 8192 takes the chunked (online-softmax) attention
LM_CONTEXTS = ((2048, 4), (8192, 4))
BF16_OPS_PER_S = 989e12                           # H100 SXM dense bf16 tensor cores
# phases 17-21, training after serving.  TF32 stays off (main), so the GNNs'
# float32 products run outside the tensor cores and their bounds take
# FP32_OPS_PER_S; the LM trains in bf16 on the tensor cores (BF16_OPS_PER_S).
LM_TRAIN_ARCH, LM_TRAIN_SHAPE = "granite-moe-1b-a400m", "train_4k"
LM_TRAIN_BATCH = 4            # of the registry's 256 sequences of train_4k: what one card holds
TRAIN_WARM, TRAIN_TIMED = 1, 5
LAUNCH_TRAIN_ARCH, LAUNCH_TRAIN_STEPS = "qwen1.5-0.5b", 4
LAUNCH_TRAIN_KEYS = ["arch", "steps", "final_loss", "first_loss", "tokens", "tok_per_s",
                     "restarts", "straggler_events", "params"]      # the reference's launcher
# the largest registry shape one card holds per GNN.  At ogb_products (61,859,140
# edges) one [E, 128] float32 edge tensor of meshgraphnet is 31.7 GB and one
# processor layer's [E/2, 3 * 512] edge input of graphcast 190 GB, so those two
# train on minibatch_lg: 1024 seeds sampled at fanouts (15, 10) from the CSR of
# the ogb_products-sized graph
GNN_FULL_SHAPES = {"gcn-cora": "ogb_products", "meshgraphnet": "minibatch_lg",
                   "graphcast": "minibatch_lg", "schnet": "molecule"}
GNN_SEEDS, GNN_FANOUTS = 1024, (15, 10)
MOLECULES = (128, 30, 64)     # molecule: 128 graphs of 30 atoms and 64 bonds
# phases 21-23, the sharded forms and the registry's cells
SHARDED_TIMED = 3
# granite's first loss through the sharded step against the unsharded loss, and
# a cell's bf16 decode logits against the plain decode step: one bf16 step
# (2**-8) of the largest value; at (1, 1) both run the same products
SHARDED_LOSS_TOL = 2.0 ** -8
EP_FORWARD = ("deepseek-v2-lite-16b", 4, 2048)
# loss_halo against gcn.loss: the loss within 1e-5; the weights' gradients, each
# a float32 sum over 6.1e7 edges added in another order (atomically on the
# card), within 1e-4 of their largest entry (2.5e-5 measured on an H100 80GB HBM3
# at 700 W, where gcn.loss against itself moved 1.8e-5)
HALO, HALO_TOL, HALO_GRAD_TOL = 512, 1e-5, 1e-4
SEED = 0
RUN_CELLS = (("gemma-2b", "long_500k"), ("gcn-cora", "full_graph_sm"),
             ("two-tower-retrieval", "serve_p99"))
# phase 24, the dry run: one cell of each kind and step on the single-pod mesh
# (the TC bonus row comes with serve_p99, traced without --arch), each its own
# process, all at once; RUN_CELLS traced on a fake world of one against their
# real runs in phase 23
DRYRUN_CELLS = (("qwen2-7b", "prefill_32k"), ("granite-moe-1b-a400m", "train_4k"),
                ("deepseek-v2-lite-16b", "decode_32k"), ("gcn-cora", "ogb_products"),
                ("two-tower-retrieval", "train_batch"), (None, "serve_p99"))
DRYRUN_UNIT = """
import json, sys
from repro_torch.distributed import make_mesh
from repro_torch.launch import dryrun
dryrun.fake_world(1)
mesh = make_mesh((1, 1), ("data", "model"))
print(json.dumps({"/".join(key): dryrun.run_cell(*key, mesh, "unit-1x1")
                  for key in json.loads(sys.argv[1])}))
"""
# the estimate counts each storage's exact bytes, the caching allocator rounds each
# block up to 512 bytes: gcn-cora's step read 2.1e-4 above its estimate (3,860
# bytes over its small live tensors), gemma-2b's and two-tower's 0 and 7e-8 (H100
# 80GB HBM3, 700.00 W); 1e-3 leaves room for 5x that rounding and no more
DRYRUN_TOL = 1e-3
TXN_PROG = """
tc(x,y) :- arc(x,y).
tc(x,y) :- rail(x,y).
tc(x,y) :- tc(x,z), arc(z,y).
tc(x,y) :- tc(x,z), rail(z,y).
"""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def time_ms(fn, reps: int = REPS, warm: int = 3) -> float:
    """Median over ``reps`` calls, each between two CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bitmm_bound(a, k: int, n_cols: int, c_arrays: int = 1) -> tuple[float, str]:
    """Least ms of a bit-matrix product of A ``a`` (k columns) with a
    k × ``n_cols`` B, the larger of two times: the bytes it must move — A
    read once, only the rows of B that A's set columns select read once,
    and ``c_arrays`` arrays of C's size read or written once (C; or M read
    and Δ', M' written) — at the memory rate, and one multiply-add per set
    bit of A and column of B at the b1 rate."""
    from repro_torch.core.bitmatrix import popcount

    cols_set = torch.zeros(a.shape[1], dtype=torch.int32, device=a.device)
    for bit in range(32):                  # the OR of A's rows, one packed row
        cols_set |= ((a >> bit) & 1).amax(dim=0) << bit
    b_rows = int(popcount(cols_set[None]))
    words = -(-n_cols // 32)
    nbytes = (a.numel() + b_rows * words + c_arrays * a.shape[0] * words) * 4
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = 2.0 * int(popcount(a)) * n_cols / B1_OPS_PER_S * 1e3
    return max(bound_bytes, bound_ops), "operations" if bound_ops >= bound_bytes else "bytes"


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def float_err(got, want) -> float:
    """Largest |got − want| in float32; NaN where exactly one side is NaN."""
    got, want = got.float(), want.float()
    check(torch.equal(got.isnan(), want.isnan()), "NaN in different places")
    both = ~got.isnan()
    return float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0


def host_ms(fn) -> float:
    """One call on the host clock, ending in a synchronised result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    ordered = sorted(values)
    return ordered[max(0, -(-len(ordered) * q // 100) - 1)]


def device_busy_share(fn, calls: int):
    """Share of a window of ``calls`` calls in which the card ran kernels or
    copies (``device_profile``'s ``busy_share``)."""
    return device_profile(fn, calls)["busy_share"]


def device_profile(fn, calls: int) -> dict:
    """``torch.profiler`` over ``calls`` calls: the share of the window in
    which the card ran kernels or copies (one stream, so the device times
    add up; the profiler's own cost lengthens the window, so this is a lower
    bound; None where it recorded no device time), and per call the device
    events (kernels, copies, sets), the host synchronisations
    (``cuda*Synchronize``) and the six device events and host operations
    that took most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    syncs = sum(e.count for e in events
                if e.device_type != DeviceType.CUDA and "Synchronize" in e.key)
    host = [e for e in events if e.device_type != DeviceType.CUDA]

    def top(rows, attr):
        rows = sorted(rows, key=lambda e: getattr(e, attr), reverse=True)[:6]
        return {e.key[:80]: [getattr(e, attr) / calls / 1e3, e.count / calls] for e in rows}

    return {"busy_share": busy_us / wall_us if busy_us > 0 else None,
            "profiled_ms_per_call": wall_us / calls / 1e3,
            "device_events_per_call": sum(e.count for e in device) / calls,
            "host_syncs_per_call": syncs / calls,
            "top_device_ms_and_count_per_call": top(device, "self_device_time_total"),
            "top_host_ms_and_count_per_call": top(host, "self_cpu_time_total")}


def gather_stats(idx, table) -> dict:
    """Lookups, distinct rows and the share of lookups that repeat a row of
    ``idx`` over ``table``, and the least ms the card could take for the
    gather-sum: the larger of its bytes (each distinct row read once, the ids
    read and the output written once) at the memory rate and its adds at the
    float32 rate."""
    valid = idx[idx >= 0]
    lookups, rows = valid.numel(), torch.unique(valid).numel()
    elsize, d = table.element_size(), table.shape[1]
    nbytes = rows * d * elsize + idx.numel() * 4 + idx.shape[0] * d * elsize
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = lookups * d / FP32_OPS_PER_S * 1e3
    return {"lookups": lookups, "distinct_rows": rows,
            "repeat_share": 1.0 - rows / max(lookups, 1),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations"}


def repeat_case(kind: str, rng):
    """A repeat-heavy (idx, n, d) of the kernel's row stage: ``one_id`` (one
    row in every slot, D off the 16-byte vector), ``over_stage`` (enough
    bags for whole tiles of 128, each drawing its 1024 ids from 200 rows:
    more repeated rows than the stage's 32, rows wider than the stage, so
    column slices), ``nan_among_repeats`` (one row everywhere and a bag
    holding an id past the table)."""
    if kind == "over_stage":
        return rng.integers(0, 200, size=(40_001, 8)).astype(np.int32), 300, 1024
    idx = np.full((3001, 8), 7, dtype=np.int32)
    idx[::5, 3] = -1
    if kind == "one_id":
        return idx, 50, 99
    idx[17, 2] = 50                                       # past the table: a NaN bag
    return idx, 50, 256


def gather_sum_phase(dev, model, bulk) -> dict:
    """Phase 7: the kernel against its plain version on the sweep and the
    repeat-heavy cases; times at the main path's shapes (every field of a
    table as one call) and at field 0 alone (earlier runs' shape)."""
    import torch.nn.functional as F

    from repro_torch.kernels import gather_sum as kg
    from repro_torch.kernels.ref import gather_sum_plain

    rng = np.random.default_rng(0)
    sweep_err = {"float32": 0.0, "bfloat16": 0.0}

    def against_plain(idx, x, what):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            xt = x.to(dtype)
            e = float_err(kg.gather_sum(idx, xt), gather_sum_plain(idx, xt))
            check(e <= tol, f"gather_sum {dtype} differs from plain by {e} at {what}")
            key = str(dtype).removeprefix("torch.")
            sweep_err[key] = max(sweep_err[key], e)

    for b, k, n, d in GATHER_SWEEP:
        idx = torch.as_tensor(rng.integers(-1, n, size=(b, k)).astype(np.int32), device=dev)
        x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev)
        against_plain(idx, x, (b, k, n, d))
        idx[0, 0] = n                                     # an id past the table: a NaN bag
        got = kg.gather_sum(idx, x)
        check(bool(got[0].isnan().all()) and float_err(got, gather_sum_plain(idx, x)) <= 1e-5,
              f"gather_sum out-of-range id at {(b, k, n, d)}")
    for kind in GATHER_REPEATS:
        idx_np, n, d = repeat_case(kind, rng)
        idx = torch.as_tensor(idx_np, device=dev)
        x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev)
        against_plain(idx, x, kind)
        nan_bags = int(kg.gather_sum(idx, x).isnan().all(dim=1).sum())
        check(nan_bags == int((idx >= n).any(dim=1).sum()), f"gather_sum NaN bags in {kind}")

    shapes = {}
    for name, table, ids in (("user", model.user_table, bulk["user_ids"]),
                             ("item", model.item_table, bulk["item_ids"])):
        for label, part in ((name, ids.reshape(-1, ids.shape[-1])),
                            (f"{name}_field0", ids[:, 0])):
            idx = torch.as_tensor(np.ascontiguousarray(part), device=dev)
            out = kg.gather_sum(idx, table)
            err = float_err(out, gather_sum_plain(idx, table))
            check(err <= 1e-5, f"gather_sum differs from plain by {err} on {label}")
            safe, weight = idx.clamp_min(0), (idx >= 0).to(table.dtype)
            lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=weight)
            check(float_err(lib, out) <= 1e-5, "the library yardstick computes another function")
            del out, lib
            stats = gather_stats(idx, table)
            ms = time_ms(lambda: kg.gather_sum(idx, table))
            shapes[label] = {
                "idx": list(idx.shape), "table": list(table.shape), **stats,
                "max_abs_err": err, "ms": ms, "share_of_bound": stats["bound_ms"] / ms,
                "plain_ms": time_ms(lambda: gather_sum_plain(idx, table)),
                "library_ms": time_ms(
                    lambda: F.embedding_bag(safe, table, mode="sum", per_sample_weights=weight)),
            }
    emit("gather_sum", sweep_cases=2 * (len(GATHER_SWEEP) + len(GATHER_REPEATS)),
         repeat_cases=list(GATHER_REPEATS), sweep_max_abs_err=sweep_err, main_shape=shapes)
    return shapes


def recsys_phases(dev, cfg, model, bulk_stream, bulk) -> int:
    """Phases 8 and 9: serve_scores and retrieval_scores on the card, each
    with the launch count set to 0 just before and read just after; the
    plain side runs the same heads on bags from the plain version.  Returns
    the path's gather-sum launches."""
    from repro_torch.data.recsys_stream import RecsysStream
    from repro_torch.kernels import gather_sum as kg
    from repro_torch.kernels.ref import gather_sum_plain

    def to_dev(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items() if k != "log_q"}

    def plain_bags(table, ids):
        return [gather_sum_plain(f, table) for f in ids.transpose(0, 1).contiguous()]

    def plain_user(bt):
        return model.user_head(plain_bags(model.user_table, bt["user_ids"]), bt["user_dense"])

    def plain_item(ids):
        return model.item_head(plain_bags(model.item_table, ids))

    def plain_scores(bt):
        return (plain_user(bt) * plain_item(bt["item_ids"])).sum(-1) / cfg.temperature

    def request(b):
        return model.serve_scores(to_dev(b)).cpu()

    def breakdown(b, reps):
        """Median ms of each part: host → card, bags, MLPs, score, card → host."""
        parts = {k: [] for k in ("h2d", "bags", "mlp", "score", "d2h")}
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt = to_dev(b)
            torch.cuda.synchronize()
            parts["h2d"].append((time.perf_counter() - t0) * 1e3)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            ub, ib = model.user_bags(bt["user_ids"]), model.item_bags(bt["item_ids"])
            ev[1].record()
            q, v = model.user_head(ub, bt["user_dense"]), model.item_head(ib)
            ev[2].record()
            s = (q * v).sum(-1) / cfg.temperature
            ev[3].record()
            ev[3].synchronize()
            t0 = time.perf_counter()
            s.cpu()
            parts["d2h"].append((time.perf_counter() - t0) * 1e3)
            for name, a, z in (("bags", 0, 1), ("mlp", 1, 2), ("score", 2, 3)):
                parts[name].append(ev[a].elapsed_time(ev[z]))
        return {f"{k}_ms": statistics.median(v) for k, v in parts.items()}

    p99_stream = RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields,
                              cfg.item_fields, cfg.field_hots, cfg.n_dense_feat,
                              batch=P99_BATCH, seed=0)
    p99 = [p99_stream.batch(step) for step in range(P99_CALLS)]

    # -- 8. serve_scores: serve_p99 and serve_bulk -------------------------------
    for _ in range(3):
        request(p99[0])
    request(bulk)
    torch.cuda.synchronize()
    kg.gather_sum.launches = 0
    lat, p99_out = [], []
    for b in p99:
        t0 = time.perf_counter()
        p99_out.append(request(b))
        lat.append((time.perf_counter() - t0) * 1e3)
    bulk_s = []
    for _ in range(BULK_REPS):
        t0 = time.perf_counter()
        bulk_out = request(bulk)
        bulk_s.append(time.perf_counter() - t0)
    serve_launches = kg.gather_sum.launches
    calls = P99_CALLS + BULK_REPS
    check(serve_launches == 2 * calls,          # one per table: all fields in one call
          f"serve_scores launched gather_sum {serve_launches} times in {calls} calls")

    err = 0.0
    for b, got in list(zip(p99, p99_out)) + [(bulk, bulk_out)]:
        check(tuple(got.shape) == (len(b["user_ids"]),) and bool(got.isfinite().all()),
              "serve_scores gave a wrong shape or non-finite scores")
        err = max(err, float_err(got, plain_scores(to_dev(b)).cpu()))
    check(err <= SCORE_TOL, f"serve_scores differ from the plain-bag scores by {err}")
    emit("recsys_serve", config=cfg.name, tables=[list(model.user_table.shape),
                                                  list(model.item_table.shape)],
         launches=serve_launches, launches_per_call=serve_launches / calls,
         max_abs_err=err,
         serve_p99={"batch": P99_BATCH, "calls": P99_CALLS,
                    "median_ms": statistics.median(lat), "p99_ms": percentile(lat, 99),
                    "breakdown": breakdown(p99[0], 10),
                    "device_busy_share": device_busy_share(lambda: request(p99[1]), 20)},
         serve_bulk={"batch": BULK_BATCH, "reps": BULK_REPS,
                     "median_s": statistics.median(bulk_s),
                     "rows_per_s": BULK_BATCH / statistics.median(bulk_s),
                     "breakdown": breakdown(bulk, 3),
                     "device_busy_share": device_busy_share(lambda: request(bulk), 2)})

    # -- 9. retrieval_scores over a pre-embedded corpus ---------------------------
    chunks, have = [], 0
    while have < CORPUS:
        ids = bulk_stream.batch(len(chunks))["item_ids"][: CORPUS - have]
        chunks.append(ids)
        have += len(ids)
    query = RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields, cfg.item_fields,
                         cfg.field_hots, cfg.n_dense_feat, batch=1, seed=0).batch(0)

    def ask():
        vals, idx = model.retrieval_scores(to_dev(query), cand, top_k=TOP_K)
        return vals.cpu(), idx.cpu()

    torch.cuda.synchronize()
    kg.gather_sum.launches = 0
    t0 = time.perf_counter()
    cand = torch.cat([model.item_tower(torch.as_tensor(ids, device=dev)) for ids in chunks])
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    for _ in range(3):
        ask()
    q_lat = []
    for _ in range(QUERY_CALLS):
        t0 = time.perf_counter()
        vals, idx = ask()
        q_lat.append((time.perf_counter() - t0) * 1e3)
    retrieval_launches = kg.gather_sum.launches
    want = len(chunks) + 3 + QUERY_CALLS         # one per corpus chunk and per query
    check(retrieval_launches == want,
          f"retrieval launched gather_sum {retrieval_launches} times, expected {want}")

    cand_plain = torch.cat([plain_item(torch.as_tensor(ids, device=dev)) for ids in chunks])
    scores = plain_user(to_dev(query)) @ cand_plain.T / cfg.temperature
    ref_vals, ref_idx = (t.cpu() for t in torch.topk(scores, TOP_K + 1))
    check(tuple(vals.shape) == (1, TOP_K) and bool(vals.isfinite().all()),
          "retrieval_scores gave a wrong shape or non-finite scores")
    err = float_err(vals, ref_vals[:, :TOP_K])
    check(err <= SCORE_TOL, f"retrieval scores differ from the plain-bag ones by {err}")
    gaps = -torch.diff(ref_vals, dim=1) > SCORE_TOL
    apart = gaps & torch.cat([torch.ones_like(gaps[:, :1]), gaps[:, :-1]], dim=1)
    check(torch.equal(idx[apart], ref_idx[:, :TOP_K][apart]),
          "retrieval indices differ from the plain-bag ones where the scores are apart")

    qt = to_dev(query)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    ub = model.user_bags(qt["user_ids"])
    ev[1].record()
    q = model.user_head(ub, qt["user_dense"])
    ev[2].record()
    torch.topk(q @ cand.T / cfg.temperature, TOP_K)
    ev[3].record()
    ev[3].synchronize()
    emit("recsys_retrieval", corpus=int(cand.shape[0]), chunks=len(chunks),
         corpus_seconds=corpus_s, top_k=TOP_K, calls=QUERY_CALLS,
         median_ms=statistics.median(q_lat), p99_ms=percentile(q_lat, 99),
         launches=retrieval_launches, max_abs_err=err, indices_compared=int(apart.sum()),
         device_busy_share=device_busy_share(ask, 20),
         breakdown={"bags_ms": ev[0].elapsed_time(ev[1]), "mlp_ms": ev[1].elapsed_time(ev[2]),
                    "gemm_topk_ms": ev[2].elapsed_time(ev[3])})
    del cand, cand_plain, scores
    return serve_launches + retrieval_launches


def scratch_fixpoint(dev, prog, edb, cfg):
    """A from-scratch fixpoint on the card: (handle map, seconds)."""
    from repro_torch.core import Engine, EngineConfig

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(**cfg), device=dev)
    eng.run(prog, edb, return_numpy=False)
    torch.cuda.synchronize()
    return eng.take_store(), time.perf_counter() - t0


def same_as_scratch(dev, label, inst, store):
    """Every relation of the instance's latest epoch equals the from-scratch
    one, rows and counts, compared on the card; returns the facts."""
    with inst.pin() as snap:
        with torch.cuda.device(dev):
            snap.wait_ready()
        for name, want in store.items():
            got = snap.handles[name]
            check(got.count == want.count,
                  f"{label}: {name} holds {got.count} rows, from scratch {want.count}")
            if hasattr(got, "rows"):
                check(torch.equal(got.rows[: got.count], want.rows[: want.count]),
                      f"{label}: {name} differs from the from-scratch fixpoint")
            else:
                check(np.array_equal(got.to_numpy(), want.to_numpy()),
                      f"{label}: {name} differs from the from-scratch fixpoint")
    return sum(h.count for h in store.values())


def serve_phases(dev) -> dict:
    """Phase 6b: the serving layer, one line per workload.  Each timed batch
    runs with the launch counts set to 0 just before and read just after;
    every result is held bit for bit against a from-scratch ``Engine.run``
    of the final EDB.  Returns the ``bitmm`` kernels' launches in the timed
    batches."""
    from collections import Counter

    from repro_torch.configs.datalog_workloads import ALL
    from repro_torch.core import EngineConfig, bitmatrix
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.data.program_facts import csda_facts
    from repro_torch.kernels import bitmm as kb
    from repro_torch.serve_datalog import DatalogServer, MaterializedInstance

    totals = {"bitmm": 0, "bitmm_fused_delta": 0}
    scratch = functools.partial(scratch_fixpoint, dev)
    same = functools.partial(same_as_scratch, dev)

    def batch(inst, ops):
        """One timed ``apply_txn`` with the launch counts, each product's
        (M, K) and the ms between CUDA events around each product, plain or
        fused (recorded on the writer's stream)."""
        shapes = Counter()
        events = []
        saved = bitmatrix.bitmm, bitmatrix.bitmm_fused_delta

        def recording(fn):
            def call(a, b, *rest):
                shapes[(a.shape[0], b.shape[0])] += 1
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(a, b, *rest)
                end.record()
                events.append((start, end))
                return out
            return call

        torch.cuda.synchronize()
        kb.bitmm.launches = 0
        kb.bitmm_fused_delta.launches = 0
        bitmatrix.bitmm, bitmatrix.bitmm_fused_delta = (recording(fn) for fn in saved)
        t0 = time.perf_counter()
        try:
            st = inst.apply_txn(ops)
            torch.cuda.synchronize()
        finally:
            bitmatrix.bitmm, bitmatrix.bitmm_fused_delta = saved
        seconds = time.perf_counter() - t0
        used = {"bitmm": kb.bitmm.launches, "bitmm_fused_delta": kb.bitmm_fused_delta.launches}
        for k in totals:
            totals[k] += used[k]
        shapes = {"m_k_count": sorted([m, k, c] for (m, k), c in shapes.items()),
                  "ms": sum(start.elapsed_time(end) for start, end in events)}
        return st, seconds, used, shapes

    def report(label, st, seconds, used, shapes, scratch_s, facts, **extra):
        emit(label, modes=st.modes, iterations=st.iterations, inserted=st.inserted,
             removed=st.removed, derived=st.derived, retracted=st.retracted,
             epoch=st.epoch, launches=used, products=shapes,
             batch_seconds=seconds, scratch_seconds=scratch_s, facts=facts, **extra)

    def insert_workload(label, prog, edb_full, rel, cfg, spare=0):
        """Materialize at 99 % of the EDB, one warm-up batch, then the timed
        1 % insert (held-out rows avoid the relation's largest id, so the
        batch stays inside the active domain).  ``spare`` more batches are
        held out and returned for later phases."""
        edb_full = {k: np.asarray(v, np.int32) for k, v in edb_full.items()}
        k = max(len(edb_full[rel]) // 100, 1)
        vals = edb_full[rel].max(axis=1)
        cand = np.flatnonzero(vals < vals.max())[-(k * (2 + spare)):]
        mask = np.ones(len(edb_full[rel]), bool)
        mask[cand] = False
        warm, held = edb_full[rel][cand[:k]], edb_full[rel][cand[k:2 * k]]
        later = edb_full[rel][cand[2 * k:]]
        base = dict(edb_full)
        base[rel] = edb_full[rel][mask]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inst = MaterializedInstance(prog, base, EngineConfig(**cfg), device=dev)
        torch.cuda.synchronize()
        materialize_s = time.perf_counter() - t0
        inst.apply_txn([("insert", rel, warm)])
        st, seconds, used, shapes = batch(inst, [("insert", rel, held)])
        final = dict(base)
        final[rel] = np.concatenate([base[rel], warm, held])
        store, scratch_s = scratch(prog, final, cfg)
        facts = same(label, inst, store)
        report(label, st, seconds, used, shapes, scratch_s, facts, batch_rows=len(held),
               edb_rows=len(final[rel]), materialize_seconds=materialize_s)
        del store
        return inst, st, shapes, later, final

    def delete_workload(label, prog, edb_full, rel, cfg):
        """Materialize the whole EDB, one warm-up delete and re-insert, then
        the timed 1 % delete."""
        edb_full = {k: np.asarray(v, np.int32) for k, v in edb_full.items()}
        k = max(len(edb_full[rel]) // 100, 1)
        inst = MaterializedInstance(prog, edb_full, EngineConfig(**cfg), device=dev)
        warm = edb_full[rel][:k]
        inst.apply_txn([("delete", rel, warm)])
        inst.apply_txn([("insert", rel, warm)])
        st, seconds, used, shapes = batch(inst, [("delete", rel, edb_full[rel][-k:])])
        shrunk = dict(edb_full)
        shrunk[rel] = edb_full[rel][:-k]
        store, scratch_s = scratch(prog, shrunk, cfg)
        facts = same(label, inst, store)
        report(label, st, seconds, used, shapes, scratch_s, facts, batch_rows=k,
               edb_rows=len(shrunk[rel]))
        del store, inst
        return st, used

    sparse = gnp_graph(SERVE_SPARSE["n"], p=SERVE_SPARSE["p"], seed=SERVE_SPARSE["seed"])
    n = SERVE_SPARSE["n"]

    # -- TC and SG on PBME: the increments at row-compacted shapes -------------
    tc_inst = None
    for label, wl in (("serve_tc_pbme", "tc"), ("serve_sg_pbme", "sg")):
        inst, st, shapes, later, final = insert_workload(
            label, ALL[wl].program, {"arc": sparse}, "arc", {"backend": "auto"},
            spare=1 if wl == "tc" else 0)
        check(set(st.modes.values()) == {"bitmatrix"}, f"{label} ran {st.modes}")
        check(any(m < n for m, _k, _c in shapes["m_k_count"]),
              f"{label}: no bitmm launch at M < n")
        if wl == "tc":
            tc_inst, tc_later, tc_final = inst, later, final
        else:
            check(any(k < n for _m, k, _c in shapes["m_k_count"]),
                  f"{label}: no sandwich launch at K < n")
            del inst
        torch.cuda.empty_cache()

    # -- reads through DatalogServer, idle and while the writer runs -----------
    srv = DatalogServer(tc_inst, max_batch=READ_BATCH)
    srcs = [int(v) for v in np.random.default_rng(0).integers(0, n, size=READ_QUERIES)]
    read_rids, overlapped, idle, during, rounds = set(), set(), [], [], []

    def read_batch(i):
        """READ_BATCH point queries submitted together and served by one
        ``step``: a closed loop of one batch in flight."""
        rids = [srv.submit_query("tc", src=srcs[(i + j) % READ_QUERIES])
                for j in range(READ_BATCH)]
        read_rids.update(rids)
        while any(r not in srv.done for r in rids):
            srv.step()

    def latencies(rids):
        """Per request, submit to reply: queue time plus its batch's time."""
        return {r.rid: (r.queued_seconds + r.service_seconds * r.batch_size) * 1e3
                for r in srv.stats.snapshot() if r.rid in rids}

    for i in range(0, READ_IDLE, READ_BATCH):
        read_batch(i)
    idle = list(latencies(read_rids).values())
    # insert and delete the held-out 1 % in turn, reads in flight all along,
    # until enough reads overlapped a writer; the last round is an insert
    while len(rounds) % 2 == 0 or (len(rounds) < READ_ROUNDS
                                   and len(overlapped) < READ_OVERLAP):
        op = "delete" if len(rounds) % 2 else "insert"
        read_rids.clear()
        e0, give_up = tc_inst.epoch, time.perf_counter() + 60
        rid = srv.submit_txn([(op, "arc", tc_later)])
        srv.step()                                     # starts the writer
        i = 0
        while tc_inst.epoch == e0 and time.perf_counter() < give_up:
            read_batch(i)
            i += READ_BATCH
        srv.run()
        update = srv.done[rid]
        check(not isinstance(update, Exception), f"serve_reads: the {op} failed: {update}")
        lat = latencies(read_rids)
        recs = [r for r in srv.stats.snapshot() if r.rid in lat and r.concurrent]
        overlapped.update(r.rid for r in recs)
        during.extend(lat[r.rid] for r in recs)
        rounds.append({"op": op, "modes": update.modes, "seconds": update.seconds,
                       "derived": update.derived, "retracted": update.retracted,
                       "reads": len(lat), "overlapped": len(recs)})
    rids = [srv.submit_query("tc", src=v) for v in srcs]
    srv.run()
    full = dict(tc_final)
    full["arc"] = np.concatenate([tc_final["arc"], tc_later])
    store, _ = scratch(ALL["tc"].program, full, {"backend": "auto"})
    tc_rows = store["tc"].rows[: store["tc"].count]
    for v, r in zip(srcs, rids):
        want = tc_rows[tc_rows[:, 0] == v].cpu().numpy()
        check(np.array_equal(srv.done[r], want), f"serve_reads: tc(src={v}) is not exact")
    emit("serve_reads", max_batch=READ_BATCH, latency="submit to reply, ms",
         idle={"reads": len(idle), "p50_ms": statistics.median(idle),
               "p99_ms": percentile(idle, 99)},
         during_update={"reads": len(during),
                        "p50_ms": statistics.median(during) if during else None,
                        "p99_ms": percentile(during, 99) if during else None},
         rounds=rounds, exact=True)
    check(len(during) > 0, "serve_reads: no read overlapped an update")
    del srv, tc_inst, store, tc_rows
    torch.cuda.empty_cache()

    # -- a 1 % delete on G10K: the fused kernel recomputes 10^8 facts ----------
    st, used = delete_workload("serve_tc_pbme_delete", ALL["tc"].program,
                               {"arc": gnp_graph(G10K, p=0.001, seed=1)}, "arc",
                               {"backend": "auto"})
    check(st.modes == {0: "full"} and used["bitmm_fused_delta"] > 0,
          f"serve_tc_pbme_delete ran {st.modes} with {used}")
    torch.cuda.empty_cache()

    # -- DRed on the tuple backend ---------------------------------------------
    st, _ = delete_workload("serve_tc_dred", ALL["tc"].program,
                            {"arc": gnp_graph(SERVE_DRED["n"], p=SERVE_DRED["p"],
                                              seed=SERVE_DRED["seed"])},
                            "arc", {"backend": "tuple"})
    check(st.modes == {0: "dred"}, f"serve_tc_dred ran {st.modes}")

    # -- CSDA: the delta path ----------------------------------------------------
    _inst, st, *_ = insert_workload("serve_csda", ALL["csda"].program,
                                    csda_facts(3000, seed=0), "arc", {"backend": "tuple"})
    check("delta" in st.modes.values(), f"serve_csda ran {st.modes}")
    del _inst
    torch.cuda.empty_cache()

    # -- one transaction against two ---------------------------------------------
    serve_txn_phase(dev, scratch, same)
    return totals


def serve_txn_phase(dev, scratch, same) -> None:
    """``benchmarks/bench_serve_datalog.py``'s two-relation transaction: twin
    chains in ``arc`` and ``rail``; insert into one, retract from the other,
    through ``DatalogServer``, once as two requests and once as one."""
    import warnings

    from repro_torch.core import EngineConfig
    from repro_torch.serve_datalog import DatalogServer, MaterializedInstance

    n_chains, chain_len = 4, 120
    edges = np.concatenate([
        np.stack([np.arange(c * chain_len, (c + 1) * chain_len - 1),
                  np.arange(c * chain_len, (c + 1) * chain_len - 1) + 1], axis=1)
        for c in range(n_chains)]).astype(np.int32)
    k = max(len(edges) // 100, 1) // 2 or 1
    ins_pos = 30 + np.arange(k)
    dels = edges[(chain_len - 1) + 30 : (chain_len - 1) + 30 + k]
    ins = edges[ins_pos]
    mask = np.ones(len(edges), bool)
    mask[ins_pos] = False
    base_arc, rail = edges[mask], edges[mask]
    inst = MaterializedInstance(TXN_PROG, {"arc": base_arc, "rail": rail},
                                EngineConfig(backend="tuple"), device=dev)
    srv = DatalogServer(inst)
    fwd = [("insert", "arc", ins), ("delete", "rail", dels)]
    inv = [("delete", "arc", ins), ("insert", "rail", dels)]
    for ops in ([fwd[0]], [fwd[1]], inv, fwd, inv):     # warm, back to base
        inst.apply_txn(ops)

    e0 = inst.epoch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        srv.submit_insert("arc", ins)
        srv.submit_delete("rail", dels)
    srv.run()
    torch.cuda.synchronize()
    seq_s, seq_epochs = time.perf_counter() - t0, inst.epoch - e0
    inst.apply_txn(inv)

    e0 = inst.epoch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = srv.submit_txn(fwd)
    srv.run()
    torch.cuda.synchronize()
    txn_s, txn_epochs = time.perf_counter() - t0, inst.epoch - e0
    st = srv.done[rid]
    check(not isinstance(st, Exception), f"serve_txn: the transaction failed: {st}")
    final_rail = np.array(sorted(set(map(tuple, rail.tolist()))
                                 - set(map(tuple, dels.tolist()))), np.int32)
    store, scratch_s = scratch(TXN_PROG, {"arc": np.concatenate([base_arc, ins]),
                                          "rail": final_rail}, {"backend": "tuple"})
    facts = same("serve_txn", inst, store)
    check((txn_epochs, seq_epochs) == (1, 2),
          f"serve_txn published {txn_epochs} epoch(s) as one transaction, {seq_epochs} as two")
    emit("serve_txn", modes=st.modes, iterations=st.iterations, ops=len(st.ops),
         txn_epochs=txn_epochs, sequential_epochs=seq_epochs, txn_seconds=txn_s,
         sequential_seconds=seq_s, scratch_seconds=scratch_s, facts=facts)


def serve_demand_phase(dev) -> dict:
    """Phase 6d: on-demand point queries (``submit_query(..., on_demand=True)``)
    against a fresh full materialization plus selections, as
    ``benchmarks/bench_serve_datalog.py``'s ``_bench_demand`` measures them,
    one line per case.  Every demanded answer must equal the full selection
    bit for bit.  The g10k case then writes 1 % of the arcs into the base
    through the server, and one more query must respecialize (the stale
    slice is evicted) and still be exact.  Returns the kernels' launches of
    the demand arms (the specialized programs are magic sets, not TC- or
    SG-shaped, so they run the tuple operators: none expected)."""
    from repro_torch.configs.datalog_workloads import ALL
    from repro_torch.core import EngineConfig
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.data.program_facts import csda_facts
    from repro_torch.kernels import bitmm as kb
    from repro_torch.serve_datalog import DatalogServer, MaterializedInstance, PlanCache

    def launches():
        return {"bitmm": kb.bitmm.launches, "bitmm_fused_delta": kb.bitmm_fused_delta.launches}

    def counts(srv):
        m = srv.metrics()
        return {"hits": m["datalog_demand_hits_total"],
                "misses": m["datalog_demand_misses_total"],
                "fallbacks": m["datalog_demand_fallbacks_total"],
                "specialize_seconds": m["datalog_demand_specialize_seconds"]["sum"]}

    def on_demand(srv, rel, seeds):
        """The demand arm: seconds and answers of one batch of point queries."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [srv.submit_query(rel, src=s, on_demand=True) for s in seeds]
        done = srv.run()
        torch.cuda.synchronize()
        answers = [done[r] for r in rids]
        for s, a in zip(seeds, answers):
            check(isinstance(a, np.ndarray), f"serve_demand: {rel}(src={s}) failed: {a}")
        return time.perf_counter() - t0, answers

    def exact(label, rel, seeds, answers, full):
        for s, got, want in zip(seeds, answers, full):
            check(np.array_equal(got, want),
                  f"{label}: {rel}(src={s}) on demand is not the full selection")
        return True

    chains, depth = 300, 60
    nodes = np.arange(chains * depth).reshape(chains, depth)
    chain_arc = np.stack([nodes[:, :-1].ravel(), nodes[:, 1:].ravel()], 1).astype(np.int32)

    def csda_absent(base):
        present = set(np.unique(base.relation("null")[:, 0]).tolist())
        return [n for n in range(base.domain) if n not in present][:4]

    g10k = gnp_graph(G10K, p=0.001, seed=1).astype(np.int32)
    k = len(g10k) // 100
    cases = [
        ("tc", ALL["tc"].program, {"arc": chain_arc}, "tc", lambda base: [0, 60],
         {"backend": "tuple"}),
        ("csda", ALL["csda"].program, csda_facts(3000, seed=0), "null", csda_absent,
         {"backend": "tuple"}),
        ("g10k", ALL["tc"].program, {"arc": g10k[:-k]}, "tc",
         lambda base: [0, G10K // 4, G10K // 2, 3 * G10K // 4], {"backend": "auto"}),
    ]
    demand_launches = {"bitmm": 0, "bitmm_fused_delta": 0}
    for name, prog, edb, rel, pick, cfg in cases:
        edb = {r: np.asarray(v, np.int32) for r, v in edb.items()}
        cache = PlanCache()
        # the base the demand server specializes from; warm the demand plan
        # on a server that is then dropped, so the timed arm still builds
        # the slice and seeds every binding
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = MaterializedInstance(prog, edb, EngineConfig(**cfg), cache=cache, device=dev)
        torch.cuda.synchronize()
        base_s = time.perf_counter() - t0
        seeds = pick(base)
        warm = DatalogServer(base)
        warm.submit_query(rel, src=seeds[0], on_demand=True)
        warm.run()
        del warm

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = MaterializedInstance(prog, edb, EngineConfig(**cfg), cache=cache, device=dev)
        full = [ref.query(rel, src=s) for s in seeds]
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        full_iterations = ref.engine.stats.iterations
        del ref
        torch.cuda.empty_cache()

        srv = DatalogServer(base)
        kb.bitmm.launches = kb.bitmm_fused_delta.launches = 0
        demand_s, answers = on_demand(srv, rel, seeds)
        used = launches()
        for key in demand_launches:
            demand_launches[key] += used[key]
        (entry,) = srv._demand_instances.values()
        line = {"seeds": seeds, "full_seconds": full_s, "demand_seconds": demand_s,
                "full_iterations": full_iterations,
                "slice_iterations": entry["instance"].engine.stats.iterations,
                **counts(srv), "rows": [len(a) for a in answers],
                "full_rows": [len(f) for f in full],
                "exact": exact(f"serve_demand_{name}", rel, seeds, answers, full),
                "demand_launches": used, "base_seconds": base_s,
                "base_facts": sum(h.count for h in base.vstore.handles.values())}
        c = counts(srv)
        check(c["fallbacks"] == 0 and c["misses"] == 1,
              f"serve_demand_{name}: {c['misses']} specializations, {c['fallbacks']} fallbacks")
        if name == "g10k":
            # a 1 % write to the base: the next query respecializes, on the card
            check(all(len(a) >= G10K // 2 for a in answers),
                  f"serve_demand_g10k: slices of {line['rows']} rows")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rid = srv.submit_txn([("insert", "arc", g10k[-k:])])
            srv.run()
            torch.cuda.synchronize()
            write_s = time.perf_counter() - t0
            check(not isinstance(srv.done[rid], Exception),
                  f"serve_demand_g10k: the base write failed: {srv.done[rid]}")
            misses = counts(srv)["misses"]
            again_s, (again,) = on_demand(srv, rel, seeds[:1])
            check(counts(srv)["misses"] == misses + 1,
                  "serve_demand_g10k: the query after the write did not respecialize")
            want = base.query(rel, src=seeds[0])
            line["respecialize"] = {
                "write_seconds": write_s, "write_modes": srv.done[rid].modes,
                "seconds": again_s, "rows": len(again),
                "exact": exact("serve_demand_g10k (after the write)", rel, seeds[:1],
                               [again], [want]),
                **counts(srv)}
        emit(f"serve_demand_{name}", **line)
        del srv, base
        torch.cuda.empty_cache()
    check(demand_launches == {"bitmm": 0, "bitmm_fused_delta": 0},
          f"serve_demand: the magic-set slices launched {demand_launches}")
    return demand_launches


def dir_bytes(path: str) -> int:
    """Bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def fs_type(path: str) -> str:
    """The file system ``path`` lies on, as /proc/mounts names it."""
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                mnt, typ = line.split()[1:3]
                if path.startswith(mnt) and len(mnt) > len(best):
                    best, kind = mnt, typ
    except OSError:
        pass
    return kind


def kernel_counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels import bitmm as kb
    from repro_torch.kernels import gather_sum as kg

    return {"bitmm": kb.bitmm, "bitmm_fused_delta": kb.bitmm_fused_delta,
            "gather_sum": kg.gather_sum}


DURABLE_LAUNCHES = {"bitmm": 0, "bitmm_fused_delta": 0, "gather_sum": 0}


@contextlib.contextmanager
def durable_path():
    """The durability path's own work: every kernel's count set to 0 just
    before the block and read just after it, and added to
    ``DURABLE_LAUNCHES``."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    try:
        yield
    finally:
        for name, c in counters.items():
            DURABLE_LAUNCHES[name] += c.launches


@contextlib.contextmanager
def stopwatch(dev, *targets):
    """Seconds spent in each ``(owner, attribute)`` while the block runs,
    the device synchronised after each call; the attributes are restored."""
    spent = {name: 0.0 for _owner, name in targets}
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize(dev)
                spent[name] += time.perf_counter() - t0
        return call

    for owner, name, fn in saved:
        setattr(owner, name, timed(name, fn))
    try:
        yield spent
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def same_epochs(dev, label, want_inst, got_inst):
    """The latest epochs of two instances hold the same tables (padding and
    capacity included), counts and packed PBME words, compared on the card."""
    with want_inst.pin() as want, got_inst.pin() as got:
        with torch.cuda.device(dev):
            want.wait_ready()
            got.wait_ready()
        check(want.epoch == got.epoch and want.domain == got.domain,
              f"{label}: epoch/domain {got.epoch}/{got.domain}, live {want.epoch}/{want.domain}")
        check(want.handles.keys() == got.handles.keys(), f"{label}: other relations")
        for name, w in want.handles.items():
            g = got.handles[name]
            check(g.count == w.count, f"{label}: {name} holds {g.count} rows, live {w.count}")
            if hasattr(w, "rows"):
                check(torch.equal(g.rows, w.rows), f"{label}: {name}'s table differs")
            else:
                check(np.array_equal(g.to_numpy(), w.to_numpy()), f"{label}: {name} differs")
        check((want.meta or {}).keys() == (got.meta or {}).keys(), f"{label}: PBME strata")
        for idx, st in (want.meta or {}).items():
            for f in ("arc", "m"):
                check(torch.equal(got.meta[idx][f], st[f]), f"{label}: PBME {f} differs")


def durability_phases(dev) -> dict:
    """Phase 6c: snapshots, the WAL, warm restore and engine checkpoints on
    the card, each result held bit for bit against the live instance's last
    epoch and against a from-scratch ``Engine.run`` of the final EDB.  All
    roots lie under one temporary directory, removed at the end.  The
    path's own launches add up in ``DURABLE_LAUNCHES``."""
    from repro_torch.configs.datalog_workloads import ALL
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.kernels import bitmm as kb
    from repro_torch.persist import DurabilityConfig, codec, list_snapshots
    from repro_torch.serve_datalog import DatalogServer, MaterializedInstance

    tc = ALL["tc"].program
    work = tempfile.mkdtemp(prefix="chip_smoke_durability-")
    fs = fs_type(work)

    def durable(root, **kw):
        return DurabilityConfig(os.path.join(work, root), checkpoint_every_epochs=0,
                                checkpoint_wal_bytes=0, **kw)

    def write_timing(fn):
        """``fn()`` (a snapshot write) on the host clock, with its SHA-256
        passes and its device → host copies timed apart."""
        with stopwatch(dev, (codec, "_sha256"), (codec, "relation_to_blocks"),
                       (codec, "packed_to_disk")) as spent:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            seconds = time.perf_counter() - t0
        return out, {"seconds": seconds, "sha256_seconds": spent["_sha256"],
                     "device_to_host_seconds": spent["relation_to_blocks"]
                     + spent["packed_to_disk"]}

    def restore_timing(root, **kw):
        """``MaterializedInstance.restore`` on the host clock, split into the
        snapshot load (of which the SHA-256 pass and the host → device copies)
        and the WAL replay, with the kernels' launches during the replay."""
        replay = {"seconds": 0.0}
        real_replay = MaterializedInstance._replay_wal

        def timed_replay(self, wal, after_epoch):
            torch.cuda.synchronize()
            before = (kb.bitmm.launches, kb.bitmm_fused_delta.launches)
            t0 = time.perf_counter()
            real_replay(self, wal, after_epoch)
            torch.cuda.synchronize()
            replay["seconds"] = time.perf_counter() - t0
            replay["launches"] = {"bitmm": kb.bitmm.launches - before[0],
                                  "bitmm_fused_delta": kb.bitmm_fused_delta.launches - before[1]}
            replay["modes"] = [st.modes for st in self.update_log]

        MaterializedInstance._replay_wal = timed_replay
        try:
            with stopwatch(dev, (codec, "_sha256"), (codec, "relation_from_blocks")) as spent:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with durable_path():
                    inst = MaterializedInstance.restore(os.path.join(work, root),
                                                        device=dev, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            MaterializedInstance._replay_wal = real_replay
        snap_bytes = dir_bytes(inst.restore_stats["snapshot_path"])
        load = seconds - replay["seconds"]
        return inst, {"seconds": seconds, "load_seconds": load,
                      "sha256_seconds": spent["_sha256"],
                      "relations_to_device_seconds": spent["relation_from_blocks"],
                      "snapshot_bytes": snap_bytes, "load_gb_per_s": snap_bytes / load / 1e9,
                      "replay_seconds": replay["seconds"],
                      "replay_launches": replay.get("launches", {}),
                      "replay_modes": replay.get("modes", []),
                      "restore_stats": {k: v for k, v in inst.restore_stats.items()
                                        if k != "snapshot_path"}}

    def txn(srv, ops):
        """One transaction through a durable server: logged, then applied."""
        with durable_path():
            rid = srv.submit_txn(ops)
            srv.run()
        out = srv.done[rid]
        check(not isinstance(out, Exception), f"durability: a transaction failed: {out}")
        return out

    def sized(timing, path):
        timing["bytes"] = dir_bytes(path)
        timing["gb_per_s"] = timing["bytes"] / timing["seconds"] / 1e9
        return timing

    try:
        # -- durable_tc_pbme: baseline, a checkpoint, a WAL tail, restore ------
        sparse = gnp_graph(SERVE_SPARSE["n"], p=SERVE_SPARSE["p"], seed=SERVE_SPARSE["seed"])
        k = len(sparse) // 100
        vals = sparse.max(axis=1)
        cand = np.flatnonzero(vals < vals.max())[-3 * k:]    # inside the active domain
        ins1, ins2, ins3 = (sparse[cand[i * k:(i + 1) * k]] for i in range(3))
        mask = np.ones(len(sparse), bool)
        mask[cand] = False
        base = sparse[mask]
        dels = base[:k]
        live = MaterializedInstance(tc, {"arc": base}, device=dev)
        cfg = durable("tc_pbme")
        srv, baseline = write_timing(lambda: DatalogServer(live, durability=cfg))
        baseline = sized(baseline, list_snapshots(cfg.root)[-1])
        txn(srv, [("insert", "arc", ins1)])
        path, ckpt = write_timing(srv.checkpoint_now)
        ckpt = sized(ckpt, path)
        tail = [txn(srv, [("insert", "arc", ins2)]), txn(srv, [("delete", "arc", dels)])]
        check([st.modes for st in tail] == [{0: "bitmatrix"}, {0: "full"}],
              f"durable_tc_pbme: the tail ran {[st.modes for st in tail]}")
        wal_bytes = srv.durability.wal.size_bytes()
        srv.close()
        restored, restore = restore_timing("tc_pbme")
        used = restore["replay_launches"]
        check(used["bitmm"] > 0 and used["bitmm_fused_delta"] > 0,
              f"durable_tc_pbme: the replay launched {used}")
        check(restore["replay_modes"] == [st.modes for st in tail],
              f"durable_tc_pbme: the replay ran {restore['replay_modes']}")
        same_epochs(dev, "durable_tc_pbme", live, restored)
        final = np.concatenate([base[k:], ins1, ins2])
        store, _ = scratch_fixpoint(dev, tc, {"arc": final}, {"backend": "auto"})
        facts = same_as_scratch(dev, "durable_tc_pbme", restored, store)
        del store
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with durable_path():
            after = restored.apply_txn([("insert", "arc", ins3)])
        torch.cuda.synchronize()
        after_s = time.perf_counter() - t0
        check(live.apply_txn([("insert", "arc", ins3)]).modes == after.modes == {0: "bitmatrix"},
              f"durable_tc_pbme: the insert after the restore ran {after.modes}")
        same_epochs(dev, "durable_tc_pbme after restore", live, restored)
        store, _ = scratch_fixpoint(dev, tc, {"arc": np.concatenate([final, ins3])},
                                    {"backend": "auto"})
        same_as_scratch(dev, "durable_tc_pbme after restore", restored, store)
        emit("durable_tc_pbme", fs=fs, batch_rows=k, facts=facts, baseline=baseline,
             checkpoint=ckpt, wal_bytes=wal_bytes, tail_modes=[st.modes for st in tail],
             restore=restore, insert_after_restore={"modes": after.modes,
                                                    "iterations": after.iterations,
                                                    "seconds": after_s},
             exact=True)
        del live, restored, store, srv
        torch.cuda.empty_cache()

        # -- durable_g10k: 10^8 facts to disk and back, reads during a checkpoint
        edges = gnp_graph(G10K, p=0.001, seed=1)
        live = MaterializedInstance(tc, {"arc": edges}, device=dev)
        cfg = durable("g10k")
        srv, baseline = write_timing(lambda: DatalogServer(live, durability=cfg))
        baseline = sized(baseline, list_snapshots(cfg.root)[-1])
        srv.close()
        packs = {"n": 0}
        real_packed = MaterializedInstance._packed

        def counted_packed(self, handle, domain):
            packs["n"] += 1
            return real_packed(self, handle, domain)

        MaterializedInstance._packed = counted_packed
        try:
            restored, restore = restore_timing("g10k")
        finally:
            MaterializedInstance._packed = real_packed
        check(packs["n"] == 0, f"durable_g10k: the restore re-packed {packs['n']} matrices")
        same_epochs(dev, "durable_g10k", live, restored)
        del live
        store, _ = scratch_fixpoint(dev, tc, {"arc": edges}, {"backend": "auto"})
        facts = same_as_scratch(dev, "durable_g10k", restored, store)
        del store
        torch.cuda.empty_cache()
        # a 1 % insert of new edges (epoch 1), then point reads: idle, and
        # while checkpoint_now writes epoch 1 on another thread
        srv = DatalogServer(restored, durability=cfg, max_batch=READ_BATCH)
        have = set(map(tuple, edges.tolist()))
        rng = np.random.default_rng(1)
        new = []
        while len(new) < max(len(edges) // 100, 1):
            a, b = (int(v) for v in rng.integers(0, G10K, size=2))
            if a != b and (a, b) not in have:
                have.add((a, b))
                new.append((a, b))
        new = np.array(new, np.int32)
        txn(srv, [("insert", "arc", new)])
        srcs = [int(v) for v in np.random.default_rng(0).integers(0, G10K, size=READ_QUERIES)]
        answers = {}                                       # rid → (src, rows)

        def reads(count):
            rids = []
            for i in range(0, count, READ_BATCH):
                asked = {srv.submit_query("tc", src=v): v
                         for v in (srcs[(i + j) % READ_QUERIES] for j in range(READ_BATCH))}
                while any(r not in srv.done for r in asked):
                    srv.step()
                rids += asked
                answers.update((r, (v, srv.done[r])) for r, v in asked.items())
            return rids

        def latency(rids):
            lat = {r.rid: (r.queued_seconds + r.service_seconds * r.batch_size) * 1e3
                   for r in srv.stats.snapshot() if r.rid in set(rids)}
            vals = list(lat.values())
            return {"reads": len(vals), "p50_ms": statistics.median(vals),
                    "p99_ms": percentile(vals, 99)}

        reads(READ_BATCH)                                 # warm the read path, untimed
        idle = latency(reads(READ_IDLE))
        out = []
        writer = threading.Thread(target=lambda: out.append(srv.checkpoint_now()))
        writer.start()
        rids, overlapped = [], 0
        for _ in range(0, READ_IDLE, READ_BATCH):
            alive = writer.is_alive()
            batch = reads(READ_BATCH)
            rids += batch
            overlapped += READ_BATCH if alive and writer.is_alive() else 0
        writer.join()
        during = latency(rids)
        ckpt_s = srv.durability.stats()["last_checkpoint_seconds"]
        check(out and out[0] is not None and srv.durability.last_snapshot_epoch == 1,
              f"durable_g10k: the checkpoint during the reads wrote {out}")
        check(overlapped > 0, "durable_g10k: no read overlapped the checkpoint")
        store, _ = scratch_fixpoint(dev, tc, {"arc": np.concatenate([edges, new])},
                                    {"backend": "auto"})
        tc_rows = store["tc"].rows[: store["tc"].count]
        want = {v: tc_rows[tc_rows[:, 0] == v].cpu().numpy() for v in set(srcs)}
        for v, got in answers.values():
            check(np.array_equal(got, want[v]), f"durable_g10k: tc(src={v}) is not exact")
        del store, tc_rows
        ckpt_bytes = dir_bytes(out[0])
        srv.close()
        emit("durable_g10k", fs=fs, facts=facts, baseline=baseline, restore=restore,
             repacked=packs["n"], reads={"max_batch": READ_BATCH,
                                         "latency": "submit to reply, ms", "idle": idle,
                                         "during_checkpoint": during,
                                         "overlapped": overlapped},
             checkpoint_during_reads={"seconds": ckpt_s, "bytes": ckpt_bytes,
                                      "gb_per_s": ckpt_bytes / ckpt_s / 1e9},
             exact=True)
        del restored, srv, answers
        torch.cuda.empty_cache()

        engine_resume_phase(dev, os.path.join(work, "csda"))
        scenario_crash_phase(dev, os.path.join(work, "crash"))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def engine_resume_phase(dev, root) -> None:
    """CSDA 3000 on the tuple path (157 iterations): checkpoints every 16
    iterations, then a fresh engine resumed from the newest one."""
    from repro_torch.configs.datalog_workloads import ALL
    from repro_torch.core import Engine, EngineConfig
    from repro_torch.data.program_facts import csda_facts
    from repro_torch.persist import latest_valid_snapshot, list_snapshots

    prog, edb = ALL["csda"].program, csda_facts(3000)
    written = {"seconds": 0.0, "bytes": 0}
    real_save = Engine._save_fixpoint

    def timed_save(self, path, *args):
        t0 = time.perf_counter()
        real_save(self, path, *args)
        written["seconds"] += time.perf_counter() - t0
        written["bytes"] += dir_bytes(list_snapshots(path)[-1])

    runs = {}
    for label, cfg, kw in (
        ("plain", EngineConfig(backend="tuple"), {}),
        ("checkpointed", EngineConfig(backend="tuple", checkpoint_every=16,
                                      checkpoint_dir=root), {}),
        ("resumed", EngineConfig(backend="tuple"), {"resume_from": root}),
    ):
        eng = Engine(cfg, device=dev)
        Engine._save_fixpoint = timed_save
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with durable_path() if label != "plain" else contextlib.nullcontext():
                out = eng.run(prog, edb, **kw)
            torch.cuda.synchronize()
        finally:
            Engine._save_fixpoint = real_save
        runs[label] = (eng, out, time.perf_counter() - t0)
        if label == "checkpointed":
            snap = latest_valid_snapshot(root, device="cpu")
            at = (int(snap.extra_meta["stratum"]), int(snap.extra_meta["iteration"]))
            resume_bytes = dir_bytes(snap.path)
            on_disk = len(list_snapshots(root))
    plain = runs["plain"][0].stats
    for label in ("checkpointed", "resumed"):
        eng, out, _s = runs[label]
        for rel, rows in runs["plain"][1].items():
            check(np.array_equal(out[rel], rows), f"engine_resume: {label} {rel} differs")
        later = {s: n for s, n in plain.iterations.items() if s >= at[0]}
        got = {s: n for s, n in eng.stats.iterations.items() if s >= at[0]}
        check(got == later, f"engine_resume: {label} iterations {got}, plain {later}")

    def key(records):
        return [(r.stratum, r.iteration, r.idb, r.candidates, r.deduped, r.delta, r.full,
                 r.dsd_strategy) for r in records if (r.stratum, r.iteration) >= at]

    check(key(runs["resumed"][0].stats.records) == key(plain.records),
          "engine_resume: the iterations after the resume point differ")
    emit("engine_resume", workload="csda", iterations=plain.iterations, checkpoint_every=16,
         checkpoints=runs["checkpointed"][0]._ckpt_seq, on_disk=on_disk,
         resumed_at={"stratum": at[0], "iteration": at[1]},
         facts={k: len(v) for k, v in runs["plain"][1].items()},
         seconds=runs["plain"][2], seconds_with_checkpoints=runs["checkpointed"][2],
         checkpoint_writes={**written, "gb_per_s": written["bytes"] / written["seconds"] / 1e9},
         resume_seconds=runs["resumed"][2], resumed_snapshot_bytes=resume_bytes, exact=True)


def scenario_crash_phase(dev, root) -> None:
    """``tests/test_scenarios.py``'s crash while shedding, on the card: a
    torn WAL bracket after the acknowledged prefix, then a restore; and the
    burst scenario through ``repro_torch.loadgen.run_scenario``."""
    from repro_torch.core import EngineConfig
    from repro_torch.loadgen import (
        Scenario, TcWorkload, VirtualClock, bursty_times, mixed_arrivals, run_scenario,
    )
    from repro_torch.persist import DurabilityConfig
    from repro_torch.serve_datalog import (
        DatalogServer, MaterializedInstance, OverloadError, ServerLimits, UpdateStats,
    )

    tc = "tc(x,y) :- arc(x,y).\ntc(x,y) :- tc(x,z), arc(z,y)."
    tuple_cfg = EngineConfig(backend="tuple")
    rng = np.random.default_rng(0)
    edges = np.unique(rng.integers(0, 14, size=(30, 2)), axis=0).astype(np.int32)
    inst = MaterializedInstance(tc, {"arc": edges}, tuple_cfg, device=dev)
    clk = VirtualClock()
    srv = DatalogServer(inst, durability=DurabilityConfig(root, checkpoint_every_epochs=0,
                                                          checkpoint_wal_bytes=0),
                        limits=ServerLimits(max_queue_depth=2), clock=clk)
    applied, shed = [], 0
    with durable_path():
        for i in range(6):
            try:
                applied.append((srv.submit_txn([("insert", "arc",
                                                 np.array([[i, i + 20]], np.int32))]), i))
            except OverloadError:
                shed += 1
            if i % 3 == 2:
                srv.run()
        done = srv.run()
    acked = [i for rid, i in applied if isinstance(done.get(rid), UpdateStats)]
    check(acked and shed > 0, f"scenario_crash: acked {acked}, shed {shed}")
    wal = srv.durability.wal
    wal.begin_txn(inst.epoch + 1)               # the crash: a bracket with no COMMIT
    wal.append("arc", "insert", np.array([[40, 41]], np.int32), inst.epoch + 1)
    pre_crash = {rel: inst.relation(rel) for rel in ("arc", "tc")}
    wal_bytes = wal.size_bytes()
    srv.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with durable_path():
        restored = MaterializedInstance.restore(root, config=tuple_cfg, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    snap_bytes = dir_bytes(restored.restore_stats["snapshot_path"])
    for rel, want in pre_crash.items():
        check(np.array_equal(restored.relation(rel), want),
              f"scenario_crash: {rel} is not the acknowledged prefix")
    check((40, 41) not in set(map(tuple, restored.relation("arc").tolist())),
          "scenario_crash: the torn bracket replayed")
    times = bursty_times(0.5, 300.0, period=0.4, duty=0.25, duration=0.8, seed=21)
    res = run_scenario(Scenario(
        "burst", mixed_arrivals(rate=0, duration=0, times=times, seed=21, n_keys=12),
        limits=ServerLimits(max_queue_depth=8, overload_policy="reject", degrade_at=0.75),
        workload=TcWorkload(n_nodes=12, p=0.1, seed=3, config=tuple_cfg),
        service_cost=0.01), device=dev)
    check(res.exact and res.shed_total > 0 and res.completed == res.accepted,
          f"scenario_crash: the burst scenario gave {res.to_row()}")
    emit("scenario_crash", acked=acked, shed=shed, restore_stats={
        k: v for k, v in restored.restore_stats.items() if k != "snapshot_path"},
         restore_seconds=restore_s, snapshot_bytes=snap_bytes, wal_bytes=wal_bytes,
         restore_gb_per_s=(snap_bytes + wal_bytes) / restore_s / 1e9,
         torn_bracket_dropped=True, burst=res.to_row(), exact=True)


# the distributed and training phases: the schedule of the SMOKE runs (the
# CPU parity tests'; it moves the weights by about 1e-2 a step) and FULL's
# training batch
TRAIN_SCHEDULE = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
TRAIN_BATCH, TRAIN_STEPS, DP_STEPS = 512, 5, 3
SMOKE_BATCH, LAUNCH_GRAPH_N = 16, 1000


def sharded_tc_phase(dev, mesh, edges, n) -> dict:
    """Phase 10: ``tc_fixpoint_sharded`` over ``mesh`` (one NCCL rank on the
    card) in its three schedules, each assembled M held bit for bit against
    ``tc_fixpoint`` on the card with equal iterations.  The launch counts are
    set to 0 just before the three runs and read just after: returned."""
    from repro_torch.core.bitmatrix import edges_to_bitmatrix, popcount, tc_fixpoint
    from repro_torch.core.distributed import (
        SCHEDULES, assemble_bitmatrix, tc_fixpoint_sharded,
    )

    arc = edges_to_bitmatrix(torch.as_tensor(edges, device=dev), n)
    want, want_iters = tc_fixpoint(arc, n)
    words = want.shape[1]
    for schedule in SCHEDULES:     # uncounted: set up the groups' NCCL communicators
        tc_fixpoint_sharded(edges[:64] % 128, 128, mesh, schedule=schedule)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    runs = {}
    for schedule in SCHEDULES:
        before = counters["bitmm"].launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, n_pad, iters = tc_fixpoint_sharded(edges, n, mesh, schedule=schedule)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        full = assemble_bitmatrix(m, mesh, ("data",), None if schedule == "rows1d" else "model")
        check(torch.equal(full[:n, :words], want) and not bool(full[n:].any()),
              f"sharded TC ({schedule}) differs from tc_fixpoint")
        check(iters == want_iters, f"sharded TC ({schedule}) took {iters} iterations, "
              f"tc_fixpoint {want_iters}")
        per_iter = dict(tc_fixpoint_sharded.last_collective_bytes)
        runs[schedule] = {"seconds": seconds, "iterations": iters, "n_pad": n_pad,
                          "block": list(m.shape), "collective_bytes_per_iteration": per_iter,
                          "bitmm_launches": counters["bitmm"].launches - before}
        del m, full
    launches = {name: c.launches for name, c in counters.items()}
    check(launches["bitmm"] == 2 * want_iters and launches["bitmm_fused_delta"] == 0
          and launches["gather_sum"] == 0,
          f"sharded TC launched {launches}; expected {2 * want_iters} bitmm (allgather, rows1d)")
    emit("sharded_tc", n=n, edges=len(edges), mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
         backend=torch.distributed.get_backend(), facts=int(popcount(want)),
         iterations=want_iters, schedules=runs, launches=launches)
    torch.cuda.empty_cache()
    return launches


def recsys_batch(cfg, batch, step, dev, accum=1):
    from repro_torch.data.recsys_stream import RecsysStream

    b = RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields, cfg.item_fields,
                     cfg.field_hots, cfg.n_dense_feat, batch=batch, seed=0).batch(step)
    return {k: torch.as_tensor(v.reshape((accum, -1) + v.shape[1:]) if accum > 1 else v,
                               device=dev) for k, v in b.items()}


def card_against_cpu(dev, host_params, cpu_step, card_step, batch_of, what,
                     compressed=False) -> dict:
    """Three steps at SMOKE and TRAIN_SCHEDULE, of ``card_step`` on the card
    and of ``cpu_step`` (a ``make_train_step``) on the CPU, from the same
    params and the batches ``batch_of(step, device)``.  The card's
    step is handed the CPU's gradients in place of its own, which are held
    against them (1e-5 of each leaf's largest entry): Adam moves a weight by
    about lr · sign(g), so a gradient entry that cancels to float32 noise
    could otherwise take another sign on the card.  From equal gradients the
    params agree within 1e-6, mu and nu within 1e-6 of each leaf's largest
    entry, the counts exactly.  ``compressed``: ``card_step`` is
    ``make_compressed_dp_step`` over one NCCL rank, and the CPU's gradients
    take the int8 rounding with error feedback (its sum over one rank)."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.optim import compress_state_init, dequantize_int8, quantize_int8
    from repro_torch.train import init_train_state
    from repro_torch.train import step as train_step_mod

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))

    cpu = torch.device("cpu")
    real = train_step_mod.value_and_grad
    host_err = compress_state_init(host_params)
    fed, grad_err = [], 0.0

    def round_int8(g, e):                # compressed_psum over one rank, on the CPU
        e.add_(g)
        d = dequantize_int8(*quantize_int8(e))
        e.sub_(d)
        return d

    def on_cpu(*args, **kwargs):
        loss, g = real(*args, **kwargs)
        fed.append((loss, tree_map(torch.clone, g)))    # the step sums into g
        return loss, (tree_map(round_int8, g, host_err) if compressed else g)

    def on_card(*args, **kwargs):
        nonlocal grad_err
        loss, g = real(*args, **kwargs)
        want_loss, want = fed.pop(0)
        grad_err = max(grad_err, rel(loss, want_loss),
                       *(rel(a, b) for a, b in zip(tree_leaves(g), tree_leaves(want))))
        return want_loss.to(dev), tree_map(lambda t: t.to(dev, copy=True), want)

    host = init_train_state(tree_map(torch.clone, host_params))
    card = init_train_state(tree_map(lambda t: t.to(dev, copy=True), host_params))
    card_err = compress_state_init(card.params)
    losses, metric_err = [], 0.0
    try:
        for i in range(3):
            train_step_mod.value_and_grad = on_cpu
            host, want = cpu_step(host, batch_of(i, cpu))
            train_step_mod.value_and_grad = on_card
            batch = batch_of(i, dev)
            if compressed:
                card, card_err, got = card_step(card, card_err, batch)
            else:
                card, got = card_step(card, batch)
            metric_err = max(metric_err, *(rel(got[k], want[k]) for k in got))
            losses.append(float(want["loss"]))
    finally:
        train_step_mod.value_and_grad = real
    check(not fed, f"the card's step took {len(fed)} fewer gradients than the CPU's")
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(host.params), tree_leaves(host_params)))
    errs = {
        "gradient_err_of_leaf_max": grad_err,
        "metrics_rel_err": metric_err,
        "params_max_abs_err": max(float((a.cpu() - b).abs().max()) for a, b in
                                  zip(tree_leaves(card.params), tree_leaves(host.params))),
        "moments_err_of_leaf_max": max(rel(a, b) for k in ("mu", "nu") for a, b in
                                       zip(tree_leaves(card.opt[k]), tree_leaves(host.opt[k]))),
    }
    check(grad_err <= 1e-5, f"SMOKE {what}: the card's gradients differ from the CPU's by "
          f"{grad_err} of each leaf's largest entry")
    check(metric_err <= 1e-6 and errs["params_max_abs_err"] <= 1e-6
          and errs["moments_err_of_leaf_max"] <= 1e-6
          and int(card.opt["count"]) == int(host.opt["count"]) == 3
          and int(card.step) == int(host.step) == 3,
          f"SMOKE {what} on the card from the CPU's gradients differs: {errs}")
    check(moved >= 1e-3, f"SMOKE {what}: the params moved only {moved} in three steps")
    return {**errs, "params_moved": moved, "losses": losses}


def train_recsys_phase(dev, mesh, full_cfg) -> None:
    """Phase 11: ``make_train_step`` (accum 1 and 2) and
    ``make_compressed_dp_step`` on the card against the CPU at SMOKE
    (``card_against_cpu``), then training at ``full_cfg`` (FULL): plain
    steps, then compressed data-parallel steps over ``mesh``'s ``data``
    group, every MLP weight moved.  The gather-sum kernel must not launch:
    training bags take the torch-ops route."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs.two_tower_retrieval import SMOKE
    from repro_torch.models.recsys import two_tower as tt
    from repro_torch.optim import compress_state_init
    from repro_torch.train import init_train_state, make_compressed_dp_step, make_train_step
    from repro_torch.train import step as train_step_mod

    counters = kernel_counters()
    gather_before = counters["gather_sum"].launches
    host_params = tt.init_params(SMOKE, torch.Generator().manual_seed(0), device="cpu")
    smoke = {}
    for accum in (1, 2):
        def steps():
            return make_train_step(tt.loss, SMOKE, accum=accum, **TRAIN_SCHEDULE)
        smoke[f"accum{accum}"] = card_against_cpu(
            dev, host_params, steps(), steps(),
            lambda i, d: recsys_batch(SMOKE, SMOKE_BATCH, i, d, accum), f"training (accum {accum})")
    smoke["compressed_dp"] = card_against_cpu(
        dev, host_params, make_train_step(tt.loss, SMOKE, **TRAIN_SCHEDULE),
        make_compressed_dp_step(tt.loss, SMOKE, mesh, "data", **TRAIN_SCHEDULE),
        lambda i, d: recsys_batch(SMOKE, SMOKE_BATCH, i, d), "compressed DP", compressed=True)

    optimizer_events = []
    real_update = train_step_mod.adamw_update

    def timed_update(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real_update(*args, **kwargs)
        end.record()
        optimizer_events.append((start, end))
        return out

    def run(step_fn, steps, first, with_err=None):
        """``steps`` steps from batch ``first``: (ms per step, optimizer ms, losses)."""
        step_ms, losses = [], []
        nonlocal state, err_state
        for i in range(steps):
            batch = recsys_batch(full_cfg, TRAIN_BATCH, first + i, dev)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            if with_err:
                state, err_state, metrics = step_fn(state, err_state, batch)
            else:
                state, metrics = step_fn(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
        opt_ms = [s.elapsed_time(e) for s, e in optimizer_events[-steps:]]
        check(all(np.isfinite(losses)), f"training losses {losses}")
        med = statistics.median(step_ms)
        return {"steps": steps, "batch": TRAIN_BATCH, "step_ms": step_ms, "median_step_ms": med,
                "samples_per_s": TRAIN_BATCH / med * 1e3,
                "optimizer_ms": opt_ms,
                "optimizer_share": statistics.median(opt_ms) / med, "losses": losses}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tt.init_params(full_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = init_train_state(params)
    err_state = None
    mlp_before = [t.clone() for t in tree_leaves((params["user_mlp"], params["item_mlp"]))]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    train_step_mod.adamw_update = timed_update
    try:
        plain = run(make_train_step(tt.loss, full_cfg), TRAIN_STEPS, 0)
        plain["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        err_state = compress_state_init(state.params)
        compressed = run(make_compressed_dp_step(tt.loss, full_cfg, mesh, "data"), DP_STEPS,
                         TRAIN_STEPS, with_err=True)
        compressed["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    finally:
        train_step_mod.adamw_update = real_update
    check(int(state.step) == int(state.opt["count"]) == TRAIN_STEPS + DP_STEPS,
          f"train state at step {int(state.step)}, count {int(state.opt['count'])}")
    check(not any(torch.equal(a, b) for a, b in zip(
        mlp_before, tree_leaves((params["user_mlp"], params["item_mlp"])))),
        "FULL training left an MLP weight where it started")
    moved = counters["gather_sum"].launches - gather_before
    check(moved == 0, f"training launched gather_sum {moved} times")
    emit("train_recsys", smoke=smoke, config=full_cfg.name,
         tables=[list(params["user_table"].shape), list(params["item_table"].shape)],
         param_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)),
         setup_seconds=setup_s, train_step=plain,
         compressed_dp={**compressed, "world": torch.distributed.get_world_size()},
         gather_sum_launches=moved)
    del params, state, err_state
    torch.cuda.empty_cache()


def train_resilient_phase(dev, work) -> None:
    """Phase 12: ``run_resilient`` at SMOKE on the card with a failure
    injected at step 3, against an uninjected run; its checkpoints carry the
    reference's keys."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs.two_tower_retrieval import SMOKE
    from repro_torch.models.recsys import two_tower as tt
    from repro_torch.train import (
        CheckpointManager, init_train_state, make_train_step, restore_pytree, run_resilient,
    )

    def train(root, inject):
        t0 = time.perf_counter()
        out = run_resilient(
            init_state_fn=lambda: init_train_state(
                tt.init_params(SMOKE, torch.Generator(device=dev).manual_seed(0), device=dev)),
            step_fn=make_train_step(tt.loss, SMOKE, **TRAIN_SCHEDULE),
            data_fn=lambda i: recsys_batch(SMOKE, SMOKE_BATCH, i, dev),
            manager=CheckpointManager(os.path.join(work, root), save_every=2, keep=3),
            total_steps=6, device=dev, inject_failure_at=inject)
        return out, time.perf_counter() - t0

    (state, history, restarts), seconds = train("injected", 3)
    (clean, clean_history, clean_restarts), clean_seconds = train("clean", None)
    check(restarts == 1 and clean_restarts == 0, f"restarts {restarts} / {clean_restarts}")
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(state.params), tree_leaves(clean.params)))
    check(err <= 1e-5, f"the restarted run's params differ from a clean run's by {err}")

    path = CheckpointManager(os.path.join(work, "injected")).latest()[1]
    mlp = [f"{m}/{w}" for m in ("user_mlp", "item_mlp") for w in ("w0", "b0", "w1", "b1")]
    tree = ["user_table", "item_table"] + mlp
    expect = ({f"params/{k}" for k in tree} | {f"opt/mu/{k}" for k in tree}
              | {f"opt/nu/{k}" for k in tree} | {"opt/count", "step", "__step__"})
    with np.load(path) as ck:
        keys = set(ck.files)
        check(keys == expect, f"checkpoint keys {sorted(keys ^ expect)} differ from the "
              "reference's layout")
        check(int(ck["__step__"]) == 6 and ck["opt/count"].dtype == np.int32,
              "checkpoint step or count")
    restored, step = restore_pytree(path, state, device=dev)
    check(step == 6 and all(torch.equal(a, b) for a, b in
                            zip(tree_leaves(restored), tree_leaves(state))),
          "the last checkpoint does not restore the final state")
    emit("train_resilient", steps=6, restarts=restarts, history=len(history),
         clean_history=len(clean_history), max_abs_err=err, seconds=seconds,
         clean_seconds=clean_seconds, checkpoint_keys=len(keys))


def launch_datalog_phase(dev, work) -> None:
    """Phase 13: ``python -m repro_torch.launch.train --arch datalog:tc`` in
    a subprocess on the card against ``Engine.run`` in this process."""
    from repro_torch.configs.datalog_workloads import TC
    from repro_torch.core import Engine, EngineConfig
    from repro_torch.data.graphs import gnp_graph

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "datalog:tc",
         "--graph-n", str(LAUNCH_GRAPH_N), "--ckpt-dir", os.path.join(work, "launch")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout)
    eng = Engine(EngineConfig(checkpoint_every=50, checkpoint_dir=os.path.join(work, "engine")),
                 device=dev)
    out = eng.run(TC.program, {"arc": gnp_graph(LAUNCH_GRAPH_N, p=0.005, seed=0)})
    want = {k: len(v) for k, v in out.items()}
    iters = {str(k): v for k, v in eng.stats.iterations.items()}
    check(got["output_sizes"] == want and got["iterations"] == iters
          and got["backends"] == eng.stats.backend_used,
          f"the launcher printed {got}, Engine.run gave {want} in {iters}")
    emit("launch_datalog", process_seconds=seconds, launcher=got, output_sizes=want,
         iterations=iters)


def rel_err(got, want) -> float:
    """max |got − want| over max |want|, in float32 on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def lm_smoke_phase(dev, smi) -> None:
    """Phase 14: the five archs at SMOKE in float32, the same weights (drawn
    on the CPU) on the card and on the CPU: prefill and LM_DECODE_STEPS decode
    steps (each also against ``forward`` at its position), ``forward`` and
    greedy ``generate``."""
    from torch.utils._pytree import tree_map

    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve import generate

    errs = {}
    for arch in registry.LM_ARCHS:
        cfg = registry.arch_config(arch, smoke=True)
        host = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 4 + LM_DECODE_STEPS)).astype(np.int32)
        runs = {}
        for side, params in (("cpu", host), ("card", tree_map(lambda t: t.to(dev), host))):
            t = torch.as_tensor(toks, device=params["embed"].device)
            logits, cache = tf.prefill(params, t[:, :4], cfg, 4 + LM_DECODE_STEPS)
            steps = [logits]
            for pos in range(4, 4 + LM_DECODE_STEPS):
                logits, cache = tf.decode_step(params, cache, t[:, pos], pos, cfg)
                steps.append(logits)
            full, aux = tf.forward(params, t, cfg)
            greedy = generate(params, toks[:, :4], cfg, steps=LM_DECODE_STEPS, temperature=0.0)
            runs[side] = (torch.stack(steps, 1), full, aux, greedy.cpu())
        (h_steps, h_full, h_aux, h_tok), (c_steps, c_full, c_aux, c_tok) = runs["cpu"], runs["card"]
        check(c_full.device.type == "cuda", f"{arch} did not run on the card")
        errs[arch] = {"prefill_and_decode": rel_err(c_steps, h_steps),
                      "forward": rel_err(c_full, h_full),
                      "aux": abs(float(c_aux) - float(h_aux))}
        check(max(errs[arch]["prefill_and_decode"], errs[arch]["forward"],
                  errs[arch]["aux"]) <= LM_TOL,
              f"{arch} on the card differs from the CPU: {errs[arch]}")
        check(torch.equal(c_tok, h_tok), f"{arch}: greedy tokens differ between card and CPU")
        check(rel_err(c_steps, c_full[:, 3:]) <= LM_TOL,
              f"{arch}: decode differs from forward on the card")
    emit("lm_smoke", tol=LM_TOL, decode_steps=LM_DECODE_STEPS, card_against_cpu=errs, card=smi)


def lm_bound(cfg, params, batch: int, new: int, filled: int, routed: list[int]) -> dict:
    """Least ms of a call that runs ``new`` tokens of each of ``batch`` rows
    after ``filled`` cache entries (a decode step: ``new`` 1; a prefill:
    ``filled`` 0), the larger of: the bytes it must move — each weight it
    uses read once (of the embedding table only the tokens' rows unless the
    unembedding is tied to it; of a MoE layer only the ``routed`` experts),
    the cache's filled entries read and the new ones written — at the memory
    rate; and its products' operations (2 per weight and token, and
    attention over the causal (query, key) pairs: decode in MLA's absorbed
    form, prefill in its expanded one) at the bf16 rate."""
    from torch.utils._pytree import tree_leaves

    elem = torch.finfo(cfg.params_dtype).bits // 8
    d, h, n = cfg.d_model, cfg.n_heads, cfg.n_layers
    tokens = batch * new
    unread = 0 if cfg.tie_embeddings else max(cfg.vocab - tokens, 0) * d
    expert = 3 * d * cfg.d_ff_expert
    unread += sum(cfg.n_experts - r for r in routed) * expert
    if cfg.attention == "mla":
        per_entry = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        if new == 1:
            pair_ops = 2 * h * (2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        else:
            pair_ops = 2 * h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
    else:
        per_entry = 2 * cfg.n_kv_heads * cfg.head_dim
        pair_ops = 2 * h * 2 * cfg.head_dim
    pairs = new * filled + new * (new + 1) // 2        # causal (query, key) pairs per row
    cache_bytes = n * batch * (filled + new) * per_entry * elem
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)) - unread * elem
    used = cfg.active_param_count() - (0 if cfg.tie_embeddings else cfg.vocab * d)
    ops = 2.0 * tokens * used + batch * n * pairs * pair_ops
    bytes_ms = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": weight_bytes + cache_bytes, "bound_operations": ops}


def routed_in(fn) -> list[int]:
    """Distinct experts each MoE layer routed to in one call of ``fn``, as
    ``moe_apply`` records them (``layers.ROUTED``)."""
    from repro_torch.models.transformer import layers as tl

    tl.ROUTED = routed = []
    try:
        fn()
    finally:
        tl.ROUTED = None
    return routed


def lm_context_phase(dev, cfg, params, rng, prompt_len: int, batch: int) -> dict:
    """At a ``prompt_len``-token prompt and ``batch`` rows: the prefill's and
    the decode step's (over the prefilled cache) ms, bounds and peak memory,
    the step's busy share and device events; the logits must be finite."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import layers as tl

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len + 1)),
                           dtype=torch.int32, device=dev)
    prompt, max_len = toks[:, :prompt_len], prompt_len + 1
    prefill_ms = time_ms(lambda: tf.prefill(params, prompt, cfg, max_len), reps=2, warm=1)
    out = {}
    prefill_routed = routed_in(lambda: out.update(zip(
        ("logits", "cache"), tf.prefill(params, prompt, cfg, max_len))))
    cache = out["cache"]

    def step():
        return tf.decode_step(params, cache, toks[:, prompt_len], prompt_len, cfg)

    decode_ms = time_ms(step, reps=5, warm=1)
    profile = device_profile(step, calls=2)
    decode_routed = routed_in(step)
    logits, _ = step()
    check(bool(torch.isfinite(out["logits"]).all() and torch.isfinite(logits).all()),
          f"{cfg.name}: non-finite logits at a {prompt_len}-token prompt")
    got = {
        "prompt": prompt_len, "batch": batch,
        "attention": "chunked" if prompt_len >= tl.CHUNK_THRESHOLD else "sdpa",
        "prefill_ms": prefill_ms,
        "prefill_bound": lm_bound(cfg, params, batch, prompt_len, 0, prefill_routed),
        "prefill_routed_experts": prefill_routed,
        "decode_ms": decode_ms,
        "decode_bound": lm_bound(cfg, params, batch, 1, prompt_len, decode_routed),
        "decode_busy_share": profile["busy_share"],
        "decode_device_events": profile["device_events_per_call"],
        "decode_host_syncs": profile["host_syncs_per_call"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    del out, cache, logits
    return got


def chunked_against_plain(dev, cfg, params, rng, prompt_len: int) -> dict:
    """One row of a ``prompt_len``-token prefill (≥ CHUNK_THRESHOLD) through
    the chunked attention and, with the threshold lifted, through ``_sdpa``'s
    full score matrix: the last logits must agree within LM_FULL_TOL."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import layers as tl

    check(prompt_len >= tl.CHUNK_THRESHOLD, f"{prompt_len} tokens do not reach the chunked path")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, prompt_len)), dtype=torch.int32,
                             device=dev)
    chunked, _ = tf.prefill(params, prompt, cfg, prompt_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    threshold, tl.CHUNK_THRESHOLD = tl.CHUNK_THRESHOLD, 1 << 62
    try:
        plain, _ = tf.prefill(params, prompt, cfg, prompt_len)
    finally:
        tl.CHUNK_THRESHOLD = threshold
    err = rel_err(chunked, plain)
    check(err <= LM_FULL_TOL, f"{cfg.name}: chunked prefill against _sdpa {err} > {LM_FULL_TOL}")
    return {"prompt": prompt_len, "batch": 1, "err": err, "tol": LM_FULL_TOL,
            "argmax_equal": bool(torch.equal(chunked.argmax(-1), plain.argmax(-1))),
            "plain_peak_memory_bytes": torch.cuda.max_memory_allocated()}


def lm_serve_full_phase(dev, arch, smi) -> None:
    """Phase 15: ``arch`` at FULL width in bf16: LM_REQUESTS requests (drawn
    as ``launch.serve`` draws them) through ``BatchedServer``, a launcher
    smoke figure; at batch LM_BATCH and a LM_PROMPT-token prompt the prefill
    and decode-step times, the decode step's device profile, its routed
    experts and bound; decode steps against ``forward`` at the same
    positions, and the same with the cache position planted one off, to
    show what the tolerance separates; then the long contexts
    (LM_CONTEXTS) and the chunked attention against the plain one."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve import BatchedServer, generate

    cfg = registry.arch_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    leaves = tree_leaves(params)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(1, 16))) for _ in range(LM_REQUESTS)]
    generate(params, prompts[0][None], cfg, steps=2)          # uncounted: cuBLAS set-up
    server = BatchedServer(params, cfg, batch=LM_BATCH, max_len=256)
    for prompt in prompts:
        server.submit(prompt, LM_MAX_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run(seed=0)
    serve_seconds = time.perf_counter() - t0
    generated = sum(len(v) for v in done.values())
    check(sorted(done) == list(range(LM_REQUESTS))
          and all(len(v) == LM_MAX_NEW and 0 <= min(v) and max(v) < cfg.vocab
                  for v in done.values()), f"{arch}: the server returned {done}")

    max_len = LM_PROMPT + LM_DECODE_STEPS
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, max_len)), dtype=torch.int32,
                           device=dev)
    prompt = toks[:, :LM_PROMPT]
    prefill_ms = time_ms(lambda: tf.prefill(params, prompt, cfg, max_len), reps=5, warm=1)
    _, cache = tf.prefill(params, prompt, cfg, max_len)

    def step():
        return tf.decode_step(params, cache, toks[:, LM_PROMPT], LM_PROMPT, cfg)

    decode_ms = time_ms(step, reps=10, warm=2)
    profile = device_profile(step, calls=4)
    routed = routed_in(step)                 # distinct experts per MoE layer in one step
    bound = lm_bound(cfg, params, LM_BATCH, 1, LM_PROMPT, routed)
    short_peak = torch.cuda.max_memory_allocated()

    def decoded(offset: int):
        """Prefill's logits, then each decode step's, the cache position of
        every step ``offset`` from the right one."""
        logits, cache = tf.prefill(params, prompt, cfg, max_len + 1)
        got = [logits]
        for pos in range(LM_PROMPT, max_len):
            logits, cache = tf.decode_step(params, cache, toks[:, pos], pos + offset, cfg)
            got.append(logits)
        return torch.stack(got, 1)

    full, _ = tf.forward(params, toks, cfg)
    want = full[:, LM_PROMPT - 1:]
    got = decoded(0)
    err = rel_err(got, want)
    check(err <= LM_FULL_TOL, f"{arch}: decode against forward {err} > {LM_FULL_TOL}")
    planted = {f"cache_len{o:+d}": rel_err(decoded(o), want) for o in (1, -1)}
    del cache, full
    contexts = [lm_context_phase(dev, cfg, params, rng, s, b) for s, b in LM_CONTEXTS]
    chunked = chunked_against_plain(dev, cfg, params, rng, LM_CONTEXTS[-1][0])
    emit("lm_serve_full", arch=arch, dtype=cfg.dtype, card=smi,
         params=sum(t.numel() for t in leaves), param_count=cfg.param_count(),
         param_bytes=sum(t.numel() * t.element_size() for t in leaves),
         init_seconds=init_seconds, requests=len(done), generated_tokens=generated,
         serve_seconds=serve_seconds, tok_per_s=generated / serve_seconds,
         prefill_ms=prefill_ms, prefill_shape=list(prompt.shape), decode_ms=decode_ms,
         decode_batch=LM_BATCH, decode_filled=LM_PROMPT, decode_profile=profile, **bound,
         routed_experts=routed, moe_layers_per_step=len(routed),
         decode_against_forward=err, decode_against_forward_tol=LM_FULL_TOL,
         argmax_agreement=float((got.argmax(-1) == want.argmax(-1)).float().mean()),
         planted_faults=planted,
         planted_faults_separated=all(e > LM_FULL_TOL for e in planted.values()),
         peak_memory_bytes=short_peak, contexts=contexts, chunked_against_plain=chunked)
    del params, got, want, leaves
    torch.cuda.empty_cache()


def step_times(step_fn, state, batch_of, first: int, steps: int):
    """``steps`` calls of ``step_fn`` on ``batch_of(first)``, ...; each timed
    between two CUDA events (the batch is made before the first event):
    (state, ms per step, each step's metrics as numbers)."""
    ms, metrics = [], []
    for i in range(first, first + steps):
        batch = batch_of(i)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, ms, metrics


def lm_train_smoke_phase(dev, smi) -> None:
    """Phase 17a: the five LMs at SMOKE in float32, ``make_train_step(lm_loss,
    remat=True)`` on the card against the CPU (``card_against_cpu``): the MoE
    group sizes read on the host, the per-segment products and the
    recompute, under autograd on CUDA."""
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.train import make_train_step

    out = {}
    for arch in registry.LM_ARCHS:
        cfg = registry.arch_config(arch, smoke=True)
        stream = TokenStream(cfg.vocab, 2, 16, seed=1)

        def batch_of(i, d, stream=stream):
            return {k: torch.as_tensor(v, device=d) for k, v in stream.batch(i).items()}

        def steps(cfg=cfg):
            return make_train_step(tf.lm_loss, cfg, remat=True, **TRAIN_SCHEDULE)

        host = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        out[arch] = card_against_cpu(dev, host, steps(), steps(), batch_of, f"{arch} training")
    emit("lm_train_smoke", steps=3, remat=True, card_against_cpu=out, card=smi)


def smoke_graph(arch, cfg, rng, dev):
    """``tests/test_models_smoke.py``'s graph batch for ``arch`` on ``dev``,
    with 11 padded (-1) edges after the real ones."""
    from repro_torch.data.graphs import batched_molecules, grid_mesh_graph
    from repro_torch.models.gnn import GraphBatch

    pos = gids = edge_feat = None
    if arch == "schnet":
        feats, s, r, gids, pos = batched_molecules(4, 8, 16, cfg.d_in)
        labels = rng.standard_normal((4, cfg.d_out)).astype(np.float32)
    else:
        n, e = 60, 240
        s, r = grid_mesh_graph(n, e)
        feats = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
        labels = (rng.integers(0, cfg.d_out, n).astype(np.int32) if cfg.task == "node_class"
                  else rng.standard_normal((n, cfg.d_out)).astype(np.float32))
        if cfg.d_edge:
            edge_feat = rng.standard_normal((e + 11, cfg.d_edge)).astype(np.float32)
        if arch == "graphcast":
            pos = rng.standard_normal((n, 3)).astype(np.float32)
    s, r = (np.concatenate([a, np.full(11, -1, np.int32)]) for a in (s, r))
    return GraphBatch(*(None if a is None else torch.as_tensor(a, device=dev)
                        for a in (feats, s, r, edge_feat, pos, gids, labels)))


def gnn_smoke_phase(dev, smi) -> None:
    """Phase 17b: the four GNNs at SMOKE, ``make_train_step`` on the card
    against the CPU (``card_against_cpu``) on padded graph batches."""
    from repro_torch.configs import registry
    from repro_torch.models.gnn import MODELS
    from repro_torch.train import make_train_step

    out = {}
    for arch in registry.GNN_ARCHS:
        cfg = registry.arch_config(arch, smoke=True)
        model = MODELS[cfg.arch]

        def batch_of(i, d, arch=arch, cfg=cfg):
            return smoke_graph(arch, cfg, np.random.default_rng(i), d)

        def steps(model=model, cfg=cfg):
            return make_train_step(model.loss, cfg, **TRAIN_SCHEDULE)

        host = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        out[arch] = card_against_cpu(dev, host, steps(), steps(), batch_of, f"{arch} training")
    emit("gnn_smoke", steps=3, card_against_cpu=out, card=smi)


def lm_train_full_phase(dev, smi) -> float:
    """Phase 18: ``LM_TRAIN_ARCH`` at FULL width (bf16 parameters, float32
    AdamW moments) on ``LM_TRAIN_SHAPE``'s sequences of 4096 tokens,
    ``LM_TRAIN_BATCH`` a step, through ``make_train_step(lm_loss,
    remat=True)`` with the launcher's schedule: TRAIN_WARM warm and
    TRAIN_TIMED timed steps (CUDA events), then one step under the profiler.
    The warm step records the experts each MoE layer routed to, in the
    forward and again in the backward's recompute, which must route alike.
    The bound is ``_lm_train_flops`` (6 · active parameters · tokens) at the
    bf16 tensor-core rate."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import layers as tl
    from repro_torch.train import init_train_state, make_train_step

    cfg = registry.arch_config(LM_TRAIN_ARCH)
    seq = registry._LM_SHAPE_DEFS[LM_TRAIN_SHAPE]["seq"]
    total = TRAIN_WARM + TRAIN_TIMED + 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(
        tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    start_wq = state.params["layers"]["attn"]["wq"][0].clone()
    stream = TokenStream(cfg.vocab, LM_TRAIN_BATCH, seq, seed=0)

    def batch_of(i):
        return {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(i).items()}

    step_fn = make_train_step(tf.lm_loss, cfg, remat=True, peak_lr=3e-4,
                              warmup_steps=max(total // 20, 10), total_steps=total)
    tl.ROUTED = routed = []
    try:
        state, warm_ms, warm = step_times(step_fn, state, batch_of, 0, TRAIN_WARM)
    finally:
        tl.ROUTED = None
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    per_step = routed[:2 * n_moe]
    check(len(routed) == 2 * n_moe * TRAIN_WARM and per_step[n_moe:] == per_step[:n_moe][::-1],
          f"{cfg.name}: the recompute routed otherwise than the forward: {routed}")
    state, ms, timed = step_times(step_fn, state, batch_of, TRAIN_WARM, TRAIN_TIMED)
    box = {"state": state, "i": TRAIN_WARM + TRAIN_TIMED}

    def one_step():
        box["state"], _ = step_fn(box["state"], batch_of(box["i"]))
        box["i"] += 1

    profile = device_profile(one_step, calls=1)
    state = box["state"]
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in warm + timed]
    check(all(np.isfinite(losses)) and all(np.isfinite(m["gnorm"]) for m in warm + timed),
          f"{cfg.name}: training losses {losses}")
    moved = not torch.equal(state.params["layers"]["attn"]["wq"][0], start_wq)
    check(int(state.step) == total and moved,
          f"{cfg.name}: the step count is {int(state.step)} or the weights did not move")
    tokens = LM_TRAIN_BATCH * seq
    flops = registry._lm_train_flops(cfg, tokens)
    med = statistics.median(ms)
    leaves = tree_leaves(state.params)
    emit("lm_train_full", arch=LM_TRAIN_ARCH, shape=LM_TRAIN_SHAPE, batch=LM_TRAIN_BATCH,
         registry_batch=registry._LM_SHAPE_DEFS[LM_TRAIN_SHAPE]["batch"], seq=seq,
         remat=True, param_dtype=cfg.param_dtype, card=smi,
         params=sum(t.numel() for t in leaves),
         param_bytes=sum(t.numel() * t.element_size() for t in leaves),
         moment_bytes=sum(t.numel() * t.element_size()
                          for k in ("mu", "nu") for t in tree_leaves(state.opt[k])),
         init_seconds=init_seconds, warm_ms=warm_ms, step_ms=ms, median_step_ms=med,
         tok_per_s=tokens / med * 1e3, model_flops=flops,
         bound_ms=flops / BF16_OPS_PER_S * 1e3, bound_by="operations",
         bound_rate="989e12 bf16 dense tensor-core FLOP/s, NVIDIA H100 SXM data sheet",
         busy_share=profile["busy_share"], host_syncs_per_step=profile["host_syncs_per_call"],
         device_events_per_step=profile["device_events_per_call"],
         top_device_ms=profile["top_device_ms_and_count_per_call"],
         routed_experts_per_layer=per_step[:n_moe], n_experts=cfg.n_experts,
         losses=losses, gnorms=[m["gnorm"] for m in warm + timed],
         lrs=[m["lr"] for m in warm + timed], peak_memory_bytes=peak)
    del state, box, leaves
    torch.cuda.empty_cache()
    return med


def launch_train_phase(smi, work) -> None:
    """Phase 19: ``python -m repro_torch.launch.train --arch qwen1.5-0.5b
    --steps 4`` (FULL, the reference's batch 8 and sequence 256) as a
    subprocess, on the card by default: the reference's JSON, no restart."""
    from repro_torch.configs import registry

    ckpt = os.path.join(work, "launch_lm")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", LAUNCH_TRAIN_ARCH,
         "--steps", str(LAUNCH_TRAIN_STEPS), "--ckpt-dir", ckpt],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"launch.train exited {proc.returncode}: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout)
    cfg = registry.arch_config(LAUNCH_TRAIN_ARCH)
    check(list(got) == LAUNCH_TRAIN_KEYS and got["arch"] == cfg.name
          and got["steps"] == LAUNCH_TRAIN_STEPS and got["restarts"] == 0
          and got["tokens"] == LAUNCH_TRAIN_STEPS * 8 * 256 and got["params"] == cfg.param_count()
          and np.isfinite(got["first_loss"]) and np.isfinite(got["final_loss"]),
          f"launch.train printed {got}")
    emit("launch_train", process_seconds=seconds, launcher=got, checkpoint_bytes=dir_bytes(ckpt),
         card=smi)
    shutil.rmtree(ckpt, ignore_errors=True)


def pad_edges(senders, receivers, e_pad: int):
    """Edge lists padded with -1 to ``e_pad`` entries."""
    fill = np.full(e_pad - len(senders), -1, np.int32)
    return np.concatenate([senders, fill]), np.concatenate([receivers, fill])


def flatten_blocks(blocks, n_seeds: int):
    """Two sampled blocks as one graph: nodes ``[seeds | hop-1 slots | hop-2
    slots]`` (global ids; a masked slot holds node 0) and an edge from each
    slot to its parent's position, -1 at both ends where the slot is masked."""
    b1, b2 = blocks
    k1, k2 = b1.src.shape[0], b2.src.shape[0]
    dev = b1.src.device
    ids = torch.cat([b1.nodes.int(), b2.nodes, torch.where(b2.mask, b2.src, 0)])
    senders = n_seeds + torch.arange(k1 + k2, dtype=torch.int32, device=dev)
    receivers = torch.cat([b1.dst, n_seeds + b2.dst])
    mask = torch.cat([b1.mask, b2.mask])
    return ids, torch.where(mask, senders, -1), torch.where(mask, receivers, -1)


def gnn_bound(arch, cfg, n: int, e: int, batch, params) -> dict:
    """Least ms of a train step, the larger of: ``_gnn_flops`` (forward and
    backward) at the float32 rate (TF32 off), and the bytes it must move —
    the batch read once, params, mu and nu each read and written once — at
    the memory rate."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import registry

    ops = registry._gnn_flops(arch, cfg, n, e)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in batch if t is not None) + 6 * param_bytes
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_operations": ops, "bound_bytes": nbytes}


def gnn_train_full_phase(dev, smi) -> float:
    """Phase 20: the four GNNs at FULL width, each on the largest registry
    shape one card holds (GNN_FULL_SHAPES): ``make_train_step``, TRAIN_WARM
    warm and TRAIN_TIMED timed steps (CUDA events), the bound, peak memory
    and finite losses.  gcn-cora trains on the whole ``grid_mesh_graph`` of
    ogb_products' size, its edges padded to a multiple of 512 with -1 as the
    registry's cell is; meshgraphnet and graphcast on one minibatch_lg batch
    that the port's ``NeighborSampler`` draws on the card from that graph's
    CSR (``flatten_blocks``); schnet on ``batched_molecules``."""
    import dataclasses

    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import registry
    from repro_torch.data.graphs import batched_molecules, grid_mesh_graph
    from repro_torch.models.gnn import MODELS, GraphBatch
    from repro_torch.relational.sampler import NeighborSampler, build_csr
    from repro_torch.train import init_train_state, make_train_step

    gen = torch.Generator(device=dev).manual_seed(0)
    big = registry._GNN_SHAPE_DEFS["ogb_products"]
    t0 = time.perf_counter()
    senders, receivers = grid_mesh_graph(big["n"], big["e"])
    graph_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    row_ptr, col = build_csr(senders, receivers, big["n"])
    csr_seconds = time.perf_counter() - t0
    sampler = NeighborSampler(row_ptr, col, GNN_FANOUTS, device=dev)
    del row_ptr, col
    seeds = torch.randperm(big["n"], generator=gen, device=dev)[:GNN_SEEDS].int()
    sample_ms = time_ms(lambda: sampler.sample(gen, seeds), reps=10, warm=2)
    blocks = sampler.sample(gen, seeds)
    ids, mb_senders, mb_receivers = flatten_blocks(blocks, GNN_SEEDS)
    mb = registry._GNN_SHAPE_DEFS["minibatch_lg"]
    check(ids.shape[0] == mb["n"] and mb_senders.shape[0] == mb["e"],
          f"the flattened minibatch has {ids.shape[0]} nodes and {mb_senders.shape[0]} edges, "
          f"minibatch_lg {mb['n']} and {mb['e']}")
    sampled = {"fanouts": list(GNN_FANOUTS), "seeds": GNN_SEEDS, "sample_ms": sample_ms,
               "graph_seconds": graph_seconds, "csr_seconds": csr_seconds,
               "masked_slots": int((mb_senders < 0).sum())}
    del sampler, blocks

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    results = {}
    for arch, shape in GNN_FULL_SHAPES.items():
        sd = registry._GNN_SHAPE_DEFS[shape]
        cfg = dataclasses.replace(registry.arch_config(arch), d_in=sd["d"])
        n, e = sd["n"], sd["e"]
        pos = gids = edge_feat = None
        if shape == "ogb_products":
            s, r = pad_edges(senders, receivers, -(-e // 512) * 512)
            s, r = torch.as_tensor(s, device=dev), torch.as_tensor(r, device=dev)
            feats = randn(n, sd["d"])
        elif shape == "minibatch_lg":
            s, r = mb_senders, mb_receivers
            feats = randn(big["n"], sd["d"])[ids.long()]
        else:
            b, atoms, bonds = MOLECULES
            feats, s, r, gids, pos = batched_molecules(b, atoms, bonds, sd["d"])
            s, r = pad_edges(s, r, -(-e // 512) * 512)
            feats, s, r, gids, pos = (torch.as_tensor(a, device=dev)
                                      for a in (feats, s, r, gids, pos))
        if cfg.task == "node_class":
            labels = torch.randint(0, cfg.d_out, (n,), generator=gen, device=dev,
                                   dtype=torch.int32)
        elif cfg.task == "graph_reg":
            labels = randn(MOLECULES[0], cfg.d_out)
        else:
            labels = randn(n, cfg.d_out)
        if cfg.d_edge:
            edge_feat = randn(s.shape[0], cfg.d_edge)
        if arch == "graphcast" and pos is None:
            pos = randn(n, 3)
        batch = GraphBatch(feats, s, r, edge_feat, pos, gids, labels)
        check(feats.shape[0] == n, f"{arch} at {shape}: {feats.shape[0]} nodes, not {n}")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = MODELS[cfg.arch]
        state = init_train_state(model.init_params(cfg, gen, device=dev))
        step_fn = make_train_step(model.loss, cfg)
        state, warm_ms, warm = step_times(step_fn, state, lambda i: batch, 0, TRAIN_WARM)
        state, ms, timed = step_times(step_fn, state, lambda i: batch, TRAIN_WARM, TRAIN_TIMED)
        losses = [m["loss"] for m in warm + timed]
        check(all(np.isfinite(losses)), f"{arch} at {shape}: losses {losses}")
        med = statistics.median(ms)
        results[arch] = {
            "shape": shape, "n": n, "e": e, "e_padded": int(s.shape[0]), "d_in": cfg.d_in,
            "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
            "params": sum(t.numel() for t in tree_leaves(state.params)),
            "warm_ms": warm_ms, "step_ms": ms, "median_step_ms": med,
            **gnn_bound(arch, cfg, n, e, batch, state.params),
            "losses": losses, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        }
        del batch, state, feats, s, r, edge_feat, pos, gids, labels
    emit("gnn_train_full", tf32=False, minibatch=sampled, models=results, card=smi)
    torch.cuda.empty_cache()
    return results["gcn-cora"]["median_step_ms"]


def tree_leaves_of(tree) -> list:
    """The tensors of a tree (``None`` is a leaf in torch's trees)."""
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if x is not None]


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside the block (references to compare with) are
    taken back out of the wrappers' counts."""
    counters = kernel_counters()
    saved = {name: c.launches for name, c in counters.items()}
    try:
        yield
    finally:
        for name, c in counters.items():
            c.launches = saved[name]


def sharded_lm_phase(dev, mesh, smi, plain_ms: float) -> None:
    """Phase 21: granite's sharded step through the expert-parallel MoE, and
    deepseek's forward under the mesh against the dense dispatch."""
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed import batch_sharding, mesh_context, param_sharding, place
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import layers as tl
    from repro_torch.train import init_train_state, make_sharded_train_step

    ep_calls = []
    ep = tl._moe_apply_ep

    def counted(*args):
        ep_calls.append(1)
        return ep(*args)

    cfg = registry.arch_config(LM_TRAIN_ARCH)
    seq = registry._LM_SHAPE_DEFS[LM_TRAIN_SHAPE]["seq"]
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(
        tf.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev))
    stream = TokenStream(cfg.vocab, LM_TRAIN_BATCH, seq, seed=SEED)

    def whole(i):
        return {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(i).items()}

    with torch.no_grad():
        plain_loss = float(tf.lm_loss(state.params, whole(0), cfg, remat=True))
    sh = param_sharding(state, mesh)
    state = place(state, sh)

    def batch_of(i):
        b = whole(i)
        return place(b, batch_sharding(b, mesh))

    step_fn = make_sharded_train_step(tf.lm_loss, cfg, mesh, sh.params, remat=True,
                                      peak_lr=3e-4, warmup_steps=10,
                                      total_steps=1 + SHARDED_TIMED)
    tl._moe_apply_ep, tl.ROUTED = counted, []
    routed = tl.ROUTED
    try:
        with mesh_context(mesh, ("data",)):
            state, warm_ms, warm = step_times(step_fn, state, batch_of, 0, 1)
            tl.ROUTED = None
            state, ms, timed = step_times(step_fn, state, batch_of, 1, SHARDED_TIMED)
    finally:
        tl._moe_apply_ep, tl.ROUTED = ep, None
    check(len(ep_calls) == 2 * n_moe * (1 + SHARDED_TIMED),
          f"{cfg.name}: {len(ep_calls)} expert-parallel MoE calls, expected "
          f"{2 * n_moe * (1 + SHARDED_TIMED)} (forward and recompute per layer and step)")
    losses = [m["loss"] for m in warm + timed]
    diff = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(all(np.isfinite(losses)) and diff <= SHARDED_LOSS_TOL,
          f"{cfg.name}: sharded first loss {losses[0]} against the unsharded {plain_loss}")
    granite = {
        "arch": LM_TRAIN_ARCH, "batch": LM_TRAIN_BATCH, "seq": seq, "remat": True,
        "shardings": {"sharded_leaves": sum(1 for x in tree_leaves_of(sh) if x.spec)},
        "ep_calls": len(ep_calls), "first_loss": losses[0], "unsharded_first_loss": plain_loss,
        "loss_rel_diff": diff, "tol": SHARDED_LOSS_TOL, "losses": losses,
        "warm_ms": warm_ms, "step_ms": ms, "median_step_ms": statistics.median(ms),
        "lm_train_full_median_step_ms": plain_ms,
        "routed_experts_per_layer": routed[:n_moe], "n_experts": cfg.n_experts,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del state, sh
    torch.cuda.empty_cache()

    arch, batch, seq = EP_FORWARD
    cfg = registry.arch_config(arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tf.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)
    ep_calls.clear()
    out = {}

    def forward(key):
        out[key] = tf.forward(params, tokens, cfg)

    with torch.no_grad():
        dense_routed = routed_in(lambda: forward("dense"))
        tl._moe_apply_ep = counted
        try:
            with mesh_context(mesh, ("data",)):
                ep_routed = routed_in(lambda: forward("ep"))
        finally:
            tl._moe_apply_ep = ep
    (want, want_aux), (got, got_aux) = out.pop("dense"), out.pop("ep")
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    check(len(ep_calls) == cfg.n_layers - cfg.n_dense_prefix and err <= LM_FULL_TOL,
          f"{arch}: {len(ep_calls)} expert-parallel calls, logits {err} of the largest apart")
    emit("sharded_lm", mesh=[1, 1], granite=granite, card=smi, deepseek={
        "arch": arch, "batch": batch, "seq": seq, "ep_calls": len(ep_calls),
        "logits_rel_err": err, "tol": LM_FULL_TOL, "aux": float(got_aux),
        "dense_aux": float(want_aux), "routed_experts_per_layer": ep_routed,
        "dense_routed_experts_per_layer": dense_routed, "n_experts": cfg.n_experts})
    del params, got, want
    torch.cuda.empty_cache()


def halo_gcn_phase(dev, mesh, smi, plain_ms: float) -> None:
    """Phase 22: ``loss_halo`` on a ring of one against ``gcn.loss`` at
    FULL width on the ogb_products-sized ring lattice."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data.graphs import grid_mesh_graph
    from repro_torch.models.gnn import GraphBatch, gcn
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import value_and_grad

    big = registry._GNN_SHAPE_DEFS["ogb_products"]
    n, k = big["n"], big["e"] // big["n"]
    cfg = dataclasses.replace(registry.arch_config("gcn-cora"), d_in=big["d"])
    senders, receivers = grid_mesh_graph(n, k * n)          # its lattice: no chords
    e_pad = -(-(k * n) // 512) * 512
    s, r = (torch.as_tensor(a, device=dev) for a in pad_edges(senders, receivers, e_pad))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    feats = torch.randn((n, cfg.d_in), generator=gen, device=dev)
    labels = torch.randint(0, cfg.d_out, (n,), generator=gen, device=dev, dtype=torch.int32)
    plain = GraphBatch(feats, s, r, None, None, None, labels)
    local = plain._replace(senders=torch.where(s >= 0, s + HALO, -1))
    params = gcn.init_params(cfg, gen, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    halo_kw = dict(mesh=mesh, dp_axes=("data",), halo=HALO)
    got, got_g = value_and_grad(gcn.loss_halo, params, local, cfg, **halo_kw)
    want, want_g = value_and_grad(gcn.loss, params, plain, cfg)
    _, again_g = value_and_grad(gcn.loss, params, plain, cfg)
    loss_err = abs(float(got) - float(want))
    grad_err = max(rel_err(got_g[key], want_g[key]) for key in params)
    check(loss_err <= HALO_TOL and grad_err <= HALO_GRAD_TOL,
          f"loss_halo {float(got)} against gcn.loss {float(want)}, gradients {grad_err} apart")
    runs = {}
    for name, loss_fn, batch, kw in (("halo", gcn.loss_halo, local, halo_kw),
                                     ("plain", gcn.loss, plain, {})):
        state = init_train_state({key: w.clone() for key, w in params.items()})
        step_fn = make_train_step(loss_fn, cfg, **kw)
        state, warm_ms, warm = step_times(step_fn, state, lambda i: batch, 0, 1)
        state, ms, timed = step_times(step_fn, state, lambda i: batch, 1, SHARDED_TIMED)
        runs[name] = {"warm_ms": warm_ms, "step_ms": ms, "median_step_ms": statistics.median(ms),
                      "losses": [m["loss"] for m in warm + timed]}
    check(all(np.isfinite(runs["halo"]["losses"])), f"loss_halo losses {runs['halo']['losses']}")
    emit("halo_gcn", arch="gcn-cora", n=n, e=k * n, e_padded=e_pad,
         chords_left_out=big["e"] - k * n, halo=HALO, ring=1, loss=float(got),
         gcn_loss=float(want), loss_abs_diff=loss_err, tol=HALO_TOL, grad_rel_err=grad_err,
         grad_tol=HALO_GRAD_TOL,
         gcn_grad_run_to_run=max(rel_err(again_g[key], want_g[key]) for key in params),
         steps=runs, gnn_train_full_gcn_median_step_ms=plain_ms,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), card=smi)
    del plain, local, feats, s, r
    torch.cuda.empty_cache()


def arg_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves_of(tree))


def cells_phase(dev, mesh, smi) -> dict:
    """Phase 23: every registry cell built on the mesh, then RUN_CELLS run;
    returns each run's record (``dryrun_phase`` holds the dry run's estimate
    of its peak against ``call_peak_bytes``)."""
    import collections
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.two_tower_retrieval import FULL
    from repro_torch.data.recsys_stream import RecsysStream
    from repro_torch.distributed import place
    from repro_torch.models import transformer as tf
    from repro_torch.models.gnn import GraphBatch, gcn
    from repro_torch.models.recsys import two_tower as tt
    from repro_torch.train import init_train_state, make_train_step

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cells = {key: registry.build_cell(*key, mesh) for key in registry.all_cells()}
    build_seconds = time.perf_counter() - t0
    check(torch.cuda.memory_allocated() == before, "building the cells allocated on the card")
    check(all(x.device.type == "meta" for c in cells.values() for x in tree_leaves_of(c.args)),
          "a cell's arguments are not meta tensors")
    name = "/".join
    emit("cells", built=len(cells), build_seconds=build_seconds,
         kinds=collections.Counter(c.kind for c in cells.values()),
         steps=collections.Counter(c.step for c in cells.values()),
         skipped={name(k): c.skip for k, c in cells.items() if c.skip},
         bonus=[name(k) for k, c in cells.items() if c.bonus],
         model_flops={name(k): c.model_flops for k, c in cells.items()},
         arg_bytes={name(k): arg_bytes(c.args) for k, c in cells.items()}, card=smi)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    ran = {}
    peaks = {}

    def timed_calls(fn, calls=1 + SHARDED_TIMED):
        """The calls' ms; ``peaks``: the second call's own peak (the
        allocator's peak reset before it, the first call's result freed; the
        first call also allocates the libraries' workspaces, once a process),
        what was resident then, and the peak before the reset
        (``peak_memory_bytes`` keeps both windows)."""
        out, ms = None, []
        for i in range(calls):
            out = None
            torch.cuda.synchronize()
            if i == 1:
                peaks.update(before=torch.cuda.max_memory_allocated(),
                             resident=torch.cuda.memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if i == 1:
                peaks["call"] = torch.cuda.max_memory_allocated()
        return out, ms

    for key in RUN_CELLS:
        cell = cells[key]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if cell.kind == "lm":
            cfg = registry.arch_config(key[0])
            params_sds, cache_sds, tok_sds, _ = cell.args
            seq = cache_sds["a"].shape[2]
            params = tf.init_params(cfg, gen, device=dev)
            cache = tf.init_cache(cfg, tok_sds.shape[0], seq, device=dev)
            tokens = torch.randint(0, cfg.vocab, tok_sds.shape, generator=gen, device=dev,
                                   dtype=torch.int32)
            pos = torch.tensor(seq - 1, dtype=torch.int32)
            args = place((params, cache, tokens, pos), cell.in_shardings)
            block_bytes = arg_bytes(args)
            (logits, _), ms = timed_calls(lambda: cell.fn(*args))
            with uncounted(), torch.no_grad():
                want, _ = tf.decode_step(params, cache, tokens, seq - 1, cfg)
            err = rel_err(logits, want)
            check(logits.shape == want.shape and bool(torch.isfinite(logits).all())
                  and err <= SHARDED_LOSS_TOL, f"{key}: logits {tuple(logits.shape)}, {err} apart")
            result = {"out_shape": list(logits.shape), "rel_err_vs_plain": err}
            del params, cache, args, logits, want
        elif cell.kind == "gnn":
            state_sds, g_sds = cell.args
            cfg = dataclasses.replace(registry.arch_config(key[0]),
                                      d_in=g_sds.node_feat.shape[1])
            n, e = g_sds.node_feat.shape[0], g_sds.senders.shape[0]
            snd = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
            snd[registry._GNN_SHAPE_DEFS[key[1]]["e"]:] = -1          # the padded edges
            g = GraphBatch(torch.randn((n, cfg.d_in), generator=gen, device=dev), snd,
                           torch.where(snd >= 0, torch.randint(
                               0, n, (e,), generator=gen, device=dev, dtype=torch.int32), -1),
                           None, None, None,
                           torch.randint(0, cfg.d_out, (n,), generator=gen, device=dev,
                                         dtype=torch.int32))
            params = gcn.init_params(cfg, gen, device=dev)
            box = {"state": place(init_train_state({k: w.clone() for k, w in params.items()}),
                                  cell.in_shardings[0])}
            g_blk = place(g, cell.in_shardings[1])
            block_bytes = arg_bytes((box["state"], g_blk))

            def one_step():
                box["state"], m = cell.fn(box["state"], g_blk)
                return m

            metrics, ms = timed_calls(one_step)
            with uncounted():
                plain = init_train_state(params)
                step = make_train_step(gcn.loss, cfg)
                for _ in range(1 + SHARDED_TIMED):
                    plain, want = step(plain, g)
            err = max(rel_err(box["state"].params[k], plain.params[k]) for k in params)
            check(np.isfinite(float(metrics["loss"])) and err <= 1e-5
                  and abs(float(metrics["loss"]) - float(want["loss"])) <= 1e-5,
                  f"{key}: loss {float(metrics['loss'])} against {float(want['loss'])}, "
                  f"params {err} apart")
            result = {"loss": float(metrics["loss"]), "params_rel_err_vs_plain": err}
            del box, g, g_blk, plain
        else:
            batch_sds = cell.args[1]
            params = tt.init_params(FULL, gen, device=dev)
            stream = RecsysStream(FULL.user_vocab, FULL.item_vocab, FULL.user_fields,
                                  FULL.item_fields, FULL.field_hots, FULL.n_dense_feat,
                                  batch=batch_sds["user_ids"].shape[0], seed=SEED)
            batch = {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(0).items()}
            args = place((params, batch), cell.in_shardings)
            block_bytes = arg_bytes(args)
            with torch.no_grad():
                scores, ms = timed_calls(lambda: cell.fn(*args))
                with uncounted():
                    want = tt.serve_scores(params, batch, FULL)
            err = float((scores - want).abs().max())
            check(scores.shape == want.shape and err <= SCORE_TOL,
                  f"{key}: scores {tuple(scores.shape)}, {err} from the unsharded scores")
            result = {"out_shape": list(scores.shape), "max_abs_err_vs_plain": err}
            del params, args, batch
        ran["/".join(key)] = {
            "arg_bytes": arg_bytes(cell.args), "skip": cell.skip,
            "model_flops": cell.model_flops, "call_ms": ms,
            "peak_memory_bytes": max(peaks["before"], torch.cuda.max_memory_allocated()),
            "call_peak_bytes": peaks["call"], "resident_bytes": peaks["resident"],
            "block_bytes": block_bytes, **result}
        torch.cuda.empty_cache()
    emit("cells_run", cells=ran, seed=SEED, card=smi)
    return ran


def dryrun_phase(work, run_cells, smi) -> dict:
    """Phase 24: ``python -m repro_torch.launch.dryrun`` on the single-pod
    mesh (a fake world of 256, fake CUDA tensors) for DRYRUN_CELLS, and
    RUN_CELLS traced on a fake world of one held against their real runs:
    the estimate (arguments + temp) against the warm call's own peak
    (``call_peak_bytes`` less what was resident, plus the blocks).  Returns
    the hand-written kernels' shape-only calls in the traced steps."""
    from repro_torch.kernels import bitmm as kb
    from repro_torch.launch.dryrun import TC_N

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single"]
    runs = {f"cell{i}": cmd + (["--arch", arch] if arch else [])
            + ["--shape", shape, "--out", os.path.join(work, f"cell{i}.json")]
            for i, (arch, shape) in enumerate(DRYRUN_CELLS)}
    runs["unit"] = [sys.executable, "-c", DRYRUN_UNIT, json.dumps(RUN_CELLS)]
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, argv in runs.items():   # output to files: no pipe fills while others wait
            with open(os.path.join(work, f"{name}.out"), "w") as out, \
                    open(os.path.join(work, f"{name}.err"), "w") as err:
                procs[name] = subprocess.Popen(argv, stdout=out, stderr=err, text=True, env=env)
        for p in procs.values():
            p.wait(timeout=900)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0

    def text(name, ext):
        with open(os.path.join(work, f"{name}.{ext}")) as f:
            return f.read()

    for name, p in procs.items():
        check(p.returncode == 0, f"dry run {runs[name][3:]} exited {p.returncode}: "
              f"{text(name, 'err')[-2000:]}")
    unit_out = text("unit", "out")

    recs = {}
    for i in range(len(DRYRUN_CELLS)):
        recs.update(json.loads(text(f"cell{i}", "json")))
    bad = {k: r.get("error") for k, r in recs.items() if r["status"] not in ("ok", "bonus-ok")}
    check(len(recs) == len(DRYRUN_CELLS) + 1 and not bad, f"dry-run records {sorted(recs)}: {bad}")
    total = torch.cuda.get_device_properties(0).total_memory
    cells = {k.split("|", 1)[1]: {
        "argument_bytes": r["argument_size_in_bytes"], "temp_bytes": r["temp_size_in_bytes"],
        "peak_bytes": r["argument_size_in_bytes"] + r["temp_size_in_bytes"],
        "fits": r["argument_size_in_bytes"] + r["temp_size_in_bytes"] <= total,
        "flops": r["flops"], "model_flops": r["model_flops"], "collectives": r["collectives"],
        "kernel_calls": r["kernel_calls"], "trace_s": r["trace_s"], "total_s": r["total_s"],
        **({"depths_traced": r["depths_traced"]} if "depths_traced" in r else {}),
    } for k, r in recs.items()}
    tc = cells["datalog-tc-pbme|g80k"]
    check(tc["kernel_calls"] == {"bitmm": 1}, f"the TC step reached {tc['kernel_calls']}")
    # the shape-only branch takes the kernel's own scratch: at the test shapes
    # and at the TC step's on (16, 16), in words (rows, K words, output words)
    shapes = [(m, (k + 31) // 32, (n + 31) // 32) for m, k, n in EXACT_SHAPES]
    for rows, kw, nw in shapes + [(TC_N // 16, TC_N // 32, TC_N // 32 // 16)]:
        want = kb._lib().bitmm_workspace_bytes(rows, kw, nw)
        check(kb.workspace_bytes(rows, kw, nw) == want,
              f"workspace_bytes{(rows, kw, nw)} is not the kernel's {want}")

    estimate = {}
    unit_recs = json.loads(unit_out.splitlines()[-1])
    for key, rec in unit_recs.items():
        if rec["status"] not in ("ok", "bonus-ok"):
            continue
        run = run_cells[key]
        truth = run["block_bytes"] + run["call_peak_bytes"] - run["resident_bytes"]
        est = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
        err = abs(est - truth) / truth
        estimate[key] = {"argument_bytes": rec["argument_size_in_bytes"],
                         "block_bytes": run["block_bytes"],
                         "temp_bytes": rec["temp_size_in_bytes"],
                         "step_bytes": run["call_peak_bytes"] - run["resident_bytes"],
                         "estimate_bytes": est, "truth_bytes": truth, "rel_err": err,
                         "call_peak_bytes": run["call_peak_bytes"],
                         "resident_bytes": run["resident_bytes"], "trace_s": rec["trace_s"]}
    emit("dryrun", mesh="single-pod-16x16", devices=256, total_memory=total, cells=cells,
         estimate_vs_card=estimate, tol=DRYRUN_TOL, seconds=seconds, card=smi)
    for key, rec in unit_recs.items():
        check(rec["status"] in ("ok", "bonus-ok"), f"{key} on a fake world of one: {rec}")
        got = estimate[key]
        check(got["argument_bytes"] == got["block_bytes"] and got["rel_err"] <= DRYRUN_TOL,
              f"{key}: the dry run's {got['estimate_bytes']} bytes against "
              f"{got['truth_bytes']} on the card")
    calls = {}
    for r in recs.values():
        for name, n in r["kernel_calls"].items():
            calls[name] = calls.get(name, 0) + n
    return calls


def launch_serve_phase(kind, smi) -> None:
    """Phase 16: ``python -m repro_torch.launch.serve --arch qwen1.5-0.5b
    --requests 8`` as a subprocess, on the card by default."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b",
         "--requests", str(LM_REQUESTS)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"launch.serve exited {proc.returncode}: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout)
    check(got["requests"] == LM_REQUESTS and got["generated_tokens"] == LM_REQUESTS * LM_MAX_NEW
          and got["device"] == kind, f"launch.serve printed {got}")
    emit("launch_serve", process_seconds=seconds, launcher=got, card=smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no GPU to drive",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.configs.datalog_workloads import ALL, SG, TC
        from repro_torch.configs.two_tower_retrieval import FULL
        from repro_torch.data.recsys_stream import RecsysStream
        from repro_torch.kernels import gather_sum as kg
        from repro_torch.models.recsys import TwoTower
        from repro_torch.core import Engine, EngineConfig
        from repro_torch.core.bitmatrix import (
            edges_to_bitmatrix, popcount, sg_fixpoint, tc_fixpoint, transpose_packed,
        )
        from repro_torch.data.graphs import gnp_graph, rmat_graph
        from repro_torch.data.program_facts import andersen_facts, csda_facts
        from repro_torch.kernels import _build
        from repro_torch.kernels import bitmm as kb
        from repro_torch.kernels.ref import (
            bitmm_fused_delta_plain, bitmm_plain, pack_bits, unpack_bits,
        )
    except ImportError as err:
        print(f"chip_smoke: cannot import the port ({err}); run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    kb._lib()
    kg._lib()
    ptxas = [ln.strip() for log in _build.stats["log"].values() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.stats["seconds"],
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()], ptxas=ptxas)

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def bits(rows, cols, density):
        return pack_bits(torch.rand((rows, cols), generator=gen, device=dev) < density)

    err = {"bitmm": 0, "bitmm_fused_delta": 0}
    compared = 0
    cases = [((m, k, n), d) for (m, k, n) in EXACT_SHAPES for d in (0.0, 0.02, 0.3, 1.0)]
    for (m, k, n), d in cases:
        a, b, cur = bits(m, k, d), bits(k, n, d), bits(m, n, 0.05)
        got, want = kb.bitmm(a, b), bitmm_plain(a, b)
        check(torch.equal(got, want), f"bitmm differs from plain at {(m, k, n)}, p={d}")
        for g, w in zip(kb.bitmm_fused_delta(a, b, cur), bitmm_fused_delta_plain(a, b, cur)):
            check(torch.equal(g, w), f"bitmm_fused_delta differs at {(m, k, n)}, p={d}")
        compared += 1

    edges = gnp_graph(G10K, p=0.001, seed=1)
    arc = edges_to_bitmatrix(torch.as_tensor(edges, device=dev), G10K)
    check(tuple(arc.shape) == (G10K, 313), f"arc shape {tuple(arc.shape)}")
    def mixed_a():
        """Empty, arc-sparse and dense 1024-bit K stages in turn."""
        stage = torch.arange(G10K, device=dev) // 1024
        density = torch.tensor([0.0, 1e-3, 0.5], device=dev)[stage % 3]
        return pack_bits(torch.rand((G10K, G10K), generator=gen, device=dev) < density)

    main_shape = {}
    main_a = {"sparse": arc, "mixed": mixed_a(), "dense": bits(G10K, G10K, 0.5)}
    for label, a in main_a.items():
        cur = bits(G10K, G10K, 0.05)
        got, want = kb.bitmm(a, arc), bitmm_plain(a, arc)
        err["bitmm"] = max(err["bitmm"], max_abs_err(got, want))
        check(torch.equal(got, want), f"bitmm differs from plain at n={G10K}, A {label}")
        for g, w in zip(kb.bitmm_fused_delta(a, arc, cur), bitmm_fused_delta_plain(a, arc, cur)):
            err["bitmm_fused_delta"] = max(err["bitmm_fused_delta"], max_abs_err(g, w))
            check(torch.equal(g, w), f"bitmm_fused_delta differs at n={G10K}, A {label}")
        compared += 1

        af = unpack_bits(a, G10K).half()
        bf = unpack_bits(arc, G10K).half()
        library_ms = time_ms(lambda: torch.matmul(af, bf))
        del af, bf
        row = {}
        for name, kernel, plain, c_arrays in (
            ("bitmm", lambda: kb.bitmm(a, arc), lambda: bitmm_plain(a, arc), 1),
            ("bitmm_fused_delta", lambda: kb.bitmm_fused_delta(a, arc, cur),
             lambda: bitmm_fused_delta_plain(a, arc, cur), 3),
        ):
            bound_ms, bound_by = bitmm_bound(a, G10K, G10K, c_arrays)
            row[name] = {
                "ms": time_ms(kernel),
                "plain_ms": time_ms(plain),
                "library_ms": library_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "a_density": int(popcount(a)) / (G10K * G10K),
            }
        main_shape[label] = row
        torch.cuda.empty_cache()
    # the serving increments' shapes: M frontier rows against the arc (rows of
    # the arc, and dense rows as a closure's frontier is), and the sandwich
    # product's K = k (A the transpose of k rows of the arc, B k dense rows)
    serve_shapes = {"M": {}, "K": {}}
    for m_rows in SERVE_M:
        rows = torch.randperm(G10K, generator=gen, device=dev)[:m_rows]
        for label, a in (("arc_rows", arc[rows].contiguous()), ("dense", bits(m_rows, G10K, 0.5))):
            got, want = kb.bitmm(a, arc), bitmm_plain(a, arc)
            err["bitmm"] = max(err["bitmm"], max_abs_err(got, want))
            check(torch.equal(got, want), f"bitmm differs from plain at M={m_rows}, A {label}")
            bound_ms, bound_by = bitmm_bound(a, G10K, G10K)
            serve_shapes["M"][f"{m_rows}/{label}"] = {
                "ms": time_ms(lambda: kb.bitmm(a, arc)), "bound_ms": bound_ms,
                "bound_by": bound_by, "a_density": int(popcount(a)) / (m_rows * G10K)}
            compared += 1
    for k_rows in SERVE_K:
        rows = torch.randperm(G10K, generator=gen, device=dev)[:k_rows]
        for label, a in (("arc_t", transpose_packed(arc[rows].contiguous(), G10K)),
                         ("dense", bits(G10K, k_rows, 0.5))):
            b = bits(k_rows, G10K, 0.3)
            got, want = kb.bitmm(a, b), bitmm_plain(a, b)
            err["bitmm"] = max(err["bitmm"], max_abs_err(got, want))
            check(torch.equal(got, want), f"bitmm differs from plain at K={k_rows}, A {label}")
            bound_ms, bound_by = bitmm_bound(a, k_rows, G10K)
            serve_shapes["K"][f"{k_rows}/{label}"] = {
                "ms": time_ms(lambda: kb.bitmm(a, b)), "bound_ms": bound_ms,
                "bound_by": bound_by, "a_density": int(popcount(a)) / (G10K * k_rows)}
            compared += 1
        del a, b, got, want
    emit("kernels", exact_cases=compared, max_abs_err=err, n=G10K,
         shape=[G10K, 313], main_shape=main_shape, serve_shapes=serve_shapes)

    del main_a, cur
    torch.cuda.empty_cache()

    # -- 4/5. the main path: PBME TC and SG at G10K --------------------------
    def plain_tc(arc_m, _n):
        m, delta, iters = arc_m, arc_m, 0
        while True:
            delta, m_new = bitmm_fused_delta_plain(delta, arc_m, m)
            if int(popcount(delta)) == 0:
                return m, iters + 1
            m, iters = m_new, iters + 1

    def plain_sg(arc_m, n):
        arc_t = transpose_packed(arc_m, n)
        eye = pack_bits(torch.eye(n, dtype=torch.bool, device=dev))
        sg = bitmm_plain(arc_t, arc_m) & ~eye
        delta, iters = sg, 0
        while True:
            delta = bitmm_plain(bitmm_plain(arc_t, delta), arc_m) & ~sg
            if int(popcount(delta)) == 0:
                return sg, iters + 1
            sg, iters = sg | delta, iters + 1

    def reset_launches():
        kb.bitmm.launches = 0
        kb.bitmm_fused_delta.launches = 0

    def read_launches():
        return {"bitmm": kb.bitmm.launches, "bitmm_fused_delta": kb.bitmm_fused_delta.launches}

    def per_launch_ms(fixpoint, arc_m, n):
        """One more fixpoint run, with CUDA events around each product: its
        kernel, ms, the density of its A and its bound, in launch order."""
        from repro_torch.core import bitmatrix

        records = []

        def timed(fn):
            def call(a, *rest):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(a, *rest)
                end.record()
                records.append((fn.__name__, a, start, end))
                return out
            return call

        saved = bitmatrix.bitmm, bitmatrix.bitmm_fused_delta
        bitmatrix.bitmm, bitmatrix.bitmm_fused_delta = timed(kb.bitmm), timed(kb.bitmm_fused_delta)
        try:
            fixpoint(arc_m, n)
        finally:
            bitmatrix.bitmm, bitmatrix.bitmm_fused_delta = saved
        torch.cuda.synchronize()
        return [{"kernel": name, "ms": start.elapsed_time(end),
                 "a_density": int(popcount(a)) / (a.shape[0] * n),
                 "bound_ms": bitmm_bound(a, n, n, 3 if name == "bitmm_fused_delta" else 1)[0]}
                for name, a, start, end in records]

    launches = {"bitmm": 0, "bitmm_fused_delta": 0}
    for wl, plain, fixpoint in ((TC, plain_tc, tc_fixpoint), (SG, plain_sg, sg_fixpoint)):
        eng = Engine(EngineConfig(backend="auto"))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.run(wl.program, {"arc": edges})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used = read_launches()
        n = eng.domain
        iters = eng.stats.iterations[0]
        check(eng.stats.backend_used[wl.name] == "bitmatrix", f"{wl.name} left PBME")
        expect = ({"bitmm": 0, "bitmm_fused_delta": iters} if wl is TC
                  else {"bitmm": 1 + 2 * iters, "bitmm_fused_delta": 0})
        check(used == expect, f"{wl.name} launches {used}, expected {expect}")
        launches = {k: launches[k] + used[k] for k in launches}

        got = edges_to_bitmatrix(torch.as_tensor(out[wl.name], device=dev), n)
        arc_n = edges_to_bitmatrix(torch.as_tensor(edges, device=dev), n)
        t1 = time.perf_counter()
        want, plain_iters = plain(arc_n, n)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t1
        check(torch.equal(got, want), f"{wl.name} fixpoint differs from the plain loop")
        check(plain_iters == iters, f"{wl.name} iterations {iters} vs plain {plain_iters}")
        # the kernel fixpoint loop alone, outside the counted run: the products and
        # the Δ popcounts, without the EDB upload and the matrix → rows step
        t1 = time.perf_counter()
        fixpoint(arc_n, n)
        torch.cuda.synchronize()
        fixpoint_seconds = time.perf_counter() - t1
        emit(wl.name, n=n, edges=len(edges), facts=len(out[wl.name]), iterations=iters,
             seconds=seconds, engine_seconds=eng.stats.total_seconds,
             stratum_seconds=eng.stats.stratum_seconds[0],
             fixpoint_seconds=fixpoint_seconds, to_host_seconds=seconds - eng.stats.total_seconds,
             plain_fixpoint_seconds=plain_seconds, launches=used,
             per_launch=per_launch_ms(fixpoint, arc_n, n))
        del out, got, want, arc_n
        torch.cuda.empty_cache()

    # -- 6. tuple and dense paths: the card against the CPU ----------------------
    def record_key(stats):
        return (stats.iterations, stats.backend_used, [
            (r.stratum, r.iteration, r.idb, r.candidates, r.deduped, r.delta, r.full,
             r.dsd_strategy) for r in stats.records])

    rmat = rmat_graph(14, edge_factor=10, seed=0)
    w = np.random.default_rng(0).integers(1, 100, size=len(rmat)).astype(np.int32)
    src = np.array([[int(rmat[0, 0])]], np.int32)
    workloads = [
        ("csda", csda_facts(3000)),
        ("andersen", andersen_facts(3)[0]),
        ("cc", {"arc": rmat}),
        ("reach", {"id": src, "arc": rmat}),
        ("sssp", {"id": src, "arc": np.concatenate([rmat, w[:, None]], axis=1)}),
    ]
    reset_launches()
    for name, edb in workloads:
        runs = {}
        for device in ("cuda", "cpu"):
            eng = Engine(EngineConfig(), device=device)
            t0 = time.perf_counter()
            out = eng.run(ALL[name].program, edb)
            runs[device] = (out, record_key(eng.stats), time.perf_counter() - t0)
        (g_out, g_key, g_s), (c_out, c_key, c_s) = runs["cuda"], runs["cpu"]
        check(g_out.keys() == c_out.keys(), f"{name}: relations differ")
        for rel in g_out:
            check(np.array_equal(g_out[rel], c_out[rel]), f"{name}: {rel} differs")
        check(g_key == c_key, f"{name}: iterations or per-iteration records differ")
        emit("tuple", workload=name, facts={k: len(v) for k, v in g_out.items()},
             iterations=g_key[0], backends=g_key[1],
             dsd=sorted({r[-1] for r in g_key[2]}), gpu_seconds=g_s, cpu_seconds=c_s)
    check(read_launches() == {"bitmm": 0, "bitmm_fused_delta": 0},
          "the tuple workloads launched PBME kernels")

    # -- 6b. the serving layer -------------------------------------------------------
    # counted apart: ``launches`` stays the TC/SG main path's count
    serve_launches = serve_phases(dev)
    serve_launches["gather_sum"] = 0

    # -- 6d. on-demand queries through the magic-set slices --------------------------
    serve_demand_phase(dev)
    torch.cuda.empty_cache()

    # -- 7-9. the two-tower serving path at FULL ----------------------------------
    model = TwoTower(FULL, torch.Generator(device=dev).manual_seed(0), device=dev)
    bulk_stream = RecsysStream(FULL.user_vocab, FULL.item_vocab, FULL.user_fields,
                               FULL.item_fields, FULL.field_hots, FULL.n_dense_feat,
                               batch=BULK_BATCH, seed=0)
    bulk = bulk_stream.batch(0)
    gather_shapes = gather_sum_phase(dev, model, bulk)
    launches["gather_sum"] = recsys_phases(dev, FULL, model, bulk_stream, bulk)
    err["gather_sum"] = max(v["max_abs_err"] for v in gather_shapes.values())
    del model, bulk_stream, bulk
    torch.cuda.empty_cache()

    # -- 10-13. the distributed layer and training -----------------------------------
    # one NCCL rank on a (1, 1) mesh (NCCL refuses two ranks on one card); counted
    # apart too: sharded TC's own launches
    import torch.distributed as dist
    from repro_torch.distributed import make_mesh

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train-") as work:
        dist.init_process_group("nccl", init_method=f"file://{work}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            sharded_launches = sharded_tc_phase(dev, mesh, edges, G10K)
            train_recsys_phase(dev, mesh, FULL)
        finally:
            dist.destroy_process_group()
        train_resilient_phase(dev, work)
        launch_datalog_phase(dev, work)
    torch.cuda.empty_cache()

    # -- 14-16. the transformer LMs: no kernel of the repo lies on their path ----------
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    lm_smoke_phase(dev, smi)
    for arch in LM_FULL_ARCHS:
        lm_serve_full_phase(dev, arch, smi)
    launch_serve_phase(kind, smi)
    lm_launches = {name: c.launches for name, c in counters.items()}
    check(not any(lm_launches.values()), f"the LM path launched {lm_launches}")

    # -- 17-20. training after serving: LMs and GNNs, no kernel of the repo on the path --
    for c in counters.values():
        c.launches = 0
    lm_train_smoke_phase(dev, smi)
    gnn_smoke_phase(dev, smi)
    lm_train_ms = lm_train_full_phase(dev, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm-") as work:
        launch_train_phase(smi, work)
    gcn_ms = gnn_train_full_phase(dev, smi)
    train_launches = {name: c.launches for name, c in counters.items()}
    check(not any(train_launches.values()), f"the training path launched {train_launches}")

    # -- 21-23. the sharded forms and the registry's cells on a (1, 1) NCCL mesh ------
    for c in counters.values():
        c.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharding-") as work:
        dist.init_process_group("nccl", init_method=f"file://{work}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            sharded_lm_phase(dev, mesh, smi, lm_train_ms)
            halo_gcn_phase(dev, mesh, smi, gcn_ms)
            run_cells = cells_phase(dev, mesh, smi)
        finally:
            dist.destroy_process_group()
    sharding_launches = {name: c.launches for name, c in counters.items()}
    emit("sharding_kernels", launches=sharding_launches)
    check(not any(sharding_launches.values()),
          f"the sharded forms and cells launched {sharding_launches}")
    torch.cuda.empty_cache()

    # -- 24. the dry run: the registry's cells traced for one rank of 256 ----------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun-") as work:
        dryrun_calls = dryrun_phase(work, run_cells, smi)

    # -- 6c. durability: snapshots, the WAL, restore, engine checkpoints -------------
    # last, so that its files and host buffers cannot slow phases 7-9; counted
    # apart too: the durability path's own launches, restored matrices included
    durability_phases(dev)
    check(DURABLE_LAUNCHES["bitmm"] > 0 and DURABLE_LAUNCHES["bitmm_fused_delta"] > 0,
          f"the durability path launched {DURABLE_LAUNCHES}")

    # no real tensor took a wrapper's shape-only branch
    fake = {name: c.fake_calls for name, c in kernel_counters().items()}
    check(not any(fake.values()), f"real tensors took the shape-only branch: {fake}")

    # -- report --------------------------------------------------------------
    sources = {   # name → (CUDA source, the TPU kernel it replaces)
        "bitmm": ("bitmm.cu", "src/repro/kernels/bitmm.py:99 (bitmm_call, body _bitmm_kernel)"),
        "bitmm_fused_delta": (
            "bitmm.cu",
            "src/repro/kernels/bitmm.py:131 (bitmm_fused_delta_call, body _bitmm_fused_kernel)"),
        "gather_sum": (
            "gather_sum.cu",
            "src/repro/kernels/gather_sum.py:49 (gather_sum_call, body _gather_sum_kernel)"),
    }
    # gather_sum: the item table at the main path's shape, with every table and
    # shape of phase 7 beside it
    timed = {**main_shape["dense"], "gather_sum": gather_shapes["item"]}
    tables = {"gather_sum": {
        label: {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "share_of_bound", "idx")}
        for label, v in gather_shapes.items()}}
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name][0]}",
            "replaces": sources[name][1],
            "launches": launches[name],
            "serve_launches": serve_launches[name],
            "durable_launches": DURABLE_LAUNCHES[name],
            "sharded_launches": sharded_launches[name],
            "lm_launches": lm_launches[name],
            "train_launches": train_launches[name],
            "sharding_launches": sharding_launches[name],
            "dryrun_fake_calls": dryrun_calls.get(name, 0),
            "max_abs_err": err[name],
            "ms": timed[name]["ms"],
            "plain_ms": timed[name]["plain_ms"],
            "bound_ms": timed[name]["bound_ms"],
            "bound_by": timed[name]["bound_by"],
            "library_ms": timed[name]["library_ms"],
            **({"tables": tables[name]} if name in tables else {}),
        }
        for name in sources
    ]}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
