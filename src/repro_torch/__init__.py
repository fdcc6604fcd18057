"""RecStep on PyTorch: the Datalog engine ported from ``repro`` (JAX) to torch.

Entry point::

    from repro_torch.core import Engine, EngineConfig
    rows = Engine(EngineConfig()).run(program_text, {"arc": edges})

The engine runs on CUDA unless it is given ``device="cpu"``.  PBME products
run the hand-written kernels in ``csrc/`` (built with ``nvcc`` at first use)
on a CUDA device and their plain PyTorch versions on the CPU.
"""
