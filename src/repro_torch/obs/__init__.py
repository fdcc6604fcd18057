"""Observability: the span tracer the engine records into."""
