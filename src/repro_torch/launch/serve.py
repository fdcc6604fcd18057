"""Serving launcher: batched decode of synthetic requests.

``python -m repro_torch.launch.serve --arch qwen1.5-0.5b [--smoke] --requests 8
[--batch 4] [--max-new 16] [--seed 0] [--device cuda|cpu]``

Random weights from ``--seed`` are drawn on ``--device`` (CUDA unless
``--device cpu``; without CUDA the default raises), the prompts from a numpy
generator seeded the same way as the reference's launcher, so both serve
the same requests.  Prints the reference's JSON report, plus the device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.train.serve import BatchedServer

    cfg = registry.arch_config(args.arch, smoke=args.smoke)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve runs on CUDA by default and no CUDA "
                           'device is available; pass --device cpu (device="cpu")')
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator, device=device)
    server = BatchedServer(params, cfg, batch=args.batch, max_len=256)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(1, 16))
        server.submit(rng.integers(0, cfg.vocab, plen), args.max_new)

    t0 = time.time()
    done = server.run(seed=args.seed)
    dt = time.time() - t0
    total_toks = sum(len(v) for v in done.values())
    print(json.dumps({
        "arch": cfg.name,
        "requests": len(done),
        "generated_tokens": total_toks,
        "tok_per_s": round(total_toks / dt, 1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }, indent=2))


if __name__ == "__main__":
    main()
