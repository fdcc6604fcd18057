#!/usr/bin/env python3
"""Variants of ``csrc/gather_sum.cu``'s tiles and row stage, timed on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``::

    PYTHONPATH=src python3 tools/gather_sum_variants.py [--baseline OTHER.cu] [--rounds 2]

Each variant is ``csrc/gather_sum.cu`` built with some of its ``GS_*``
constants set by ``-D`` (all variants compile at once).  ``--baseline`` adds
another source with the same C entry point (``gather_sum_launch``), such as
an older tree's ``gather_sum.cu``, timed in the same call.  ``--rounds 2``
times every variant twice, the second round in reverse order (a b b a).

Inputs, all at the two-tower FULL size: the user and item tables (5e6 and
2e6 rows of 256 float32, drawn on the card from seed 0) and
``RecsysStream(seed=0)``'s batch of 262,144 rows: each table's field 0
(``idx [262144, 8]``, the shape earlier runs timed) and all its fields as
the model passes them (user ``[1048576, 8]``, item ``[524288, 8]``); and one
diagnostic input, the item table's field 0 with every occurrence of its 256
most drawn rows sent at random to one of 64 copies of that row (appended to
the table), so that the head's reads fall on 64 times as many L2 lines with
the same number of reads and the same sums.  If the head's L2 slices set the
pace of a kernel that reads every occurrence, it runs faster there.

Each variant runs through ``kernels.gather_sum.gather_sum`` itself, is held
against the plain version (within 1e-5) and timed (``chip_smoke.time_ms``).
One JSON line per input (lookups, distinct rows, the share of lookups that
repeat a row, the bound, ``F.embedding_bag``'s ms), one per variant (ms,
share of the bound, the tile plan, the share of each tile's lookups that
repeat a row of the tile), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import float_err, gather_stats, time_ms  # noqa: E402
from repro_torch.configs.two_tower_retrieval import FULL  # noqa: E402
from repro_torch.data.recsys_stream import RecsysStream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import gather_sum as kg  # noqa: E402
from repro_torch.kernels.ref import gather_sum_plain  # noqa: E402

BUILD_LIB = kg._lib            # the cached loader, before any variant patches it
BATCH = 262_144
HEAD_ROWS, COPIES = 256, 64
# name -> -D defines; base is T = 128 bags (1024 ids) a tile whose warps claim
# bags one at a time, 32 staged rows in 32 KB sharing the hash table's bytes,
# 8 warps, registers for 3 blocks an SM (float32)
VARIANTS = {
    "base": (),
    "nostage": ("GS_STAGE_ROWS=0",),                   # tiles, every row read direct
    "s64": ("GS_STAGE_ROWS=64", "GS_STAGE_BYTES=65536"),
    "t64": ("GS_TILE_BAGS=64", "GS_TILE_IDS=512"),
    "minb2": ("GS_MIN_BLOCKS=2",),                     # 92 registers: 2 blocks an SM
    "u1_ku8": ("GS_U=1", "GS_KU=8"),                   # 8 rows of one vector in flight
}


def tile_repeat_share(idx: torch.Tensor, tile: int) -> float:
    """Share of the lookups in whole tiles of ``tile`` bags that repeat a row
    already looked up in the same tile."""
    whole = idx.shape[0] // tile * tile
    s = torch.sort(idx[:whole].reshape(-1, tile * idx.shape[1]), dim=1).values
    valid = s >= 0
    first = torch.ones_like(valid)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    lookups = int(valid.sum())
    return 1.0 - int((first & valid).sum()) / max(lookups, 1)


def baseline_lib(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build({"baseline": (path.resolve(), ())})["baseline"]))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gather_sum_launch.argtypes = [vp, vp, vp, i64, i, i64, i, i, vp]
    lib.gather_sum_launch.restype = i
    return lib


def plan(defines, bags: int, k: int, d: int, sms: int) -> dict:
    out = (ctypes.c_int * 4)()
    BUILD_LIB(defines).gather_sum_plan(bags, k, d, 0, sms, out)
    return dict(zip(("tile", "stage_rows", "slice", "smem"), out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another gather_sum.cu with the same C entry point")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds over the variants, every other one in reverse order")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_sum_variants: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    dev = torch.device("cuda")
    built = _build.build({name: (_build.CSRC / "gather_sum.cu", d) for name, d in VARIANTS.items()})
    libs = {name: functools.partial(BUILD_LIB, d) for name, d in VARIANTS.items()}
    if args.baseline is not None:
        libs["baseline"] = functools.partial(lambda lib: lib, baseline_lib(args.baseline))
    for name in libs:
        ptxas = [ln.strip() for ln in _build.stats["log"].get(name, "").splitlines()
                 if "spill" in ln or "registers" in ln]
        library = built[name].name if name in built else str(args.baseline)
        print(json.dumps({"variant": name, "library": library, "ptxas": ptxas}), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    user = torch.randn((FULL.user_vocab, FULL.embed_dim), generator=gen, device=dev).mul_(0.01)
    item = torch.randn((FULL.item_vocab, FULL.embed_dim), generator=gen, device=dev).mul_(0.01)
    b = RecsysStream(FULL.user_vocab, FULL.item_vocab, FULL.user_fields, FULL.item_fields,
                     FULL.field_hots, FULL.n_dense_feat, batch=BATCH, seed=0).batch(0)
    uids = torch.as_tensor(b["user_ids"], device=dev)
    iids = torch.as_tensor(b["item_ids"], device=dev)
    k = FULL.field_hots

    # the diagnostic: the head's occurrences spread over copies of its rows
    item_f0 = iids[:, 0].contiguous()
    counts = torch.bincount(item_f0[item_f0 >= 0].long(), minlength=FULL.item_vocab)
    head = torch.topk(counts, HEAD_ROWS).indices
    rank = torch.full((FULL.item_vocab,), -1, dtype=torch.long, device=dev)
    rank[head] = torch.arange(HEAD_ROWS, device=dev)
    r = rank[item_f0.clamp_min(0).long()]
    copy = torch.randint(0, COPIES, item_f0.shape, generator=gen, device=dev)
    spread = torch.where((item_f0 >= 0) & (r >= 0), FULL.item_vocab + r * COPIES + copy,
                         item_f0).int()
    item_copies = torch.cat([item, item[head].repeat_interleave(COPIES, dim=0)])

    inputs = {
        "user_field0": (uids[:, 0].contiguous(), user),
        "item_field0": (item_f0, item),
        "user_folded": (uids.reshape(-1, k), user),
        "item_folded": (iids.reshape(-1, k), item),
        "item_field0_head_spread": (spread, item_copies),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want, stats = {}, {}
    for name, (idx, table) in inputs.items():
        stats[name] = gather_stats(idx, table)
        safe, weight = idx.clamp_min(0), (idx >= 0).to(table.dtype)
        stats[name]["library_ms"] = time_ms(
            lambda: F.embedding_bag(safe, table, mode="sum", per_sample_weights=weight))
        want[name] = gather_sum_plain(idx, table)
        print(json.dumps({"input": name, "idx": list(idx.shape), "table": list(table.shape),
                          **stats[name]}), flush=True)

    order = list(libs)
    for variant in [v for r in range(args.rounds) for v in (order if r % 2 == 0 else order[::-1])]:
        lib = libs[variant]
        row = {"variant": variant, "defines": list(VARIANTS.get(variant, ()))}
        with mock.patch.object(kg, "_lib", lib):
            for name, (idx, table) in inputs.items():
                err = float_err(kg.gather_sum(idx, table), want[name])
                if err > 1e-5:
                    raise RuntimeError(f"{variant} differs from plain by {err} on {name}")
                ms = time_ms(lambda: kg.gather_sum(idx, table))
                cell = {"ms": ms, "share_of_bound": stats[name]["bound_ms"] / ms,
                        "max_abs_err": err}
                if variant in VARIANTS:
                    p = plan(VARIANTS[variant], idx.shape[0], k, table.shape[1], sms)
                    cell.update(p, tile_repeat_share=tile_repeat_share(idx, p["tile"]))
                row[name] = cell
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
