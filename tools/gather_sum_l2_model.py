#!/usr/bin/env python3
"""How many rows a one-pass gather-sum must read from device memory.

Runs on the host (numpy only, no GPU)::

    PYTHONPATH=src python3 tools/gather_sum_l2_model.py [--rows 25000 50000]

Models the card's L2 as an LRU cache of ``--rows`` table rows (1 KB each at
the two-tower width: 50 MB holds 50,000) and replays ``RecsysStream(seed=0)``'s
batch of 262,144 at the FULL vocabularies through it, one field of one table
in bag order, each bag's 1 KB output entering the cache after its 8 lookups.
A miss is a row read from HBM.  Prints, per table and capacity, the lookups,
the distinct rows (what ``chip_smoke.gather_stats``'s bound counts), the
misses, and the ms those misses plus the ids and the output take at the
H100's 3.35 TB/s: a floor for any kernel that sums each bag in one pass,
above the bound wherever rows come back after L2 has let them go.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.two_tower_retrieval import FULL  # noqa: E402
from repro_torch.data.recsys_stream import RecsysStream  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
BATCH = 262_144


def lru_misses(ids: np.ndarray, capacity: int) -> int:
    """Misses of an LRU cache of ``capacity`` lines over ``ids`` int32[B, K]
    (negative ids skipped), each bag's output taking one line after its ids."""
    cache: OrderedDict = OrderedDict()
    misses = 0
    for bag, row in enumerate(ids.tolist()):
        for r in row:
            if r < 0:
                continue
            if r in cache:
                cache.move_to_end(r)
            else:
                misses += 1
                cache[r] = None
                if len(cache) > capacity:
                    cache.popitem(last=False)
        cache[("out", bag)] = None
        if len(cache) > capacity:
            cache.popitem(last=False)
    return misses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[25_000, 50_000])
    args = ap.parse_args()
    batch = RecsysStream(FULL.user_vocab, FULL.item_vocab, FULL.user_fields, FULL.item_fields,
                         FULL.field_hots, FULL.n_dense_feat, batch=BATCH, seed=0).batch(0)
    row_bytes = FULL.embed_dim * 4
    for table in ("user", "item"):
        ids = batch[f"{table}_ids"][:, 0]
        valid = ids[ids >= 0]
        for capacity in args.rows:
            misses = lru_misses(ids, capacity)
            nbytes = misses * row_bytes + ids.size * 4 + ids.shape[0] * row_bytes
            print(json.dumps({
                "table": table, "idx": list(ids.shape), "l2_rows": capacity,
                "lookups": int(valid.size), "distinct_rows": int(np.unique(valid).size),
                "misses": misses, "bytes": nbytes,
                "ms_at_hbm_peak": nbytes / HBM_BYTES_PER_S * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
