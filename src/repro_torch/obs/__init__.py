"""Observability: span tracing, metrics, EXPLAIN/ANALYZE, latency statistics.

Stdlib-only apart from :func:`repro_torch.obs.profile.device_memory_stats`,
which reads the CUDA caching allocator through torch.
"""
