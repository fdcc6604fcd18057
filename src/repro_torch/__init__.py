"""RecStep on PyTorch: the Datalog engine and the two-tower model's serving
path, ported from ``repro`` (JAX) to torch.

Entry points::

    from repro_torch.core import Engine, EngineConfig
    rows = Engine(EngineConfig()).run(program_text, {"arc": edges})

    from repro_torch.models.recsys import TwoTower
    scores = TwoTower(cfg).serve_scores(batch)

Both run on CUDA unless they are given ``device="cpu"``.  PBME products and
embedding bags run the hand-written kernels in ``csrc/`` (built with
``nvcc`` at first use) on a CUDA device and their plain PyTorch versions
on the CPU.
"""
