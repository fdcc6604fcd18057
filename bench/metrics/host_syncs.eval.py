"""Engine loop: host synchronisations an evaluation, the ``syncs`` of
``engine.prep`` and ``engine.run`` (each implicit sync through PyTorch's sync
debug mode, each explicit ``torch.cuda.synchronize`` counted where made)."""

from bench.harness.spans import per_evaluation


def read(records: dict):
    return per_evaluation(records, lambda s: s.syncs, "engine.prep", "engine.run")
