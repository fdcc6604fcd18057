"""Relational primitives on torch tensors: sorted tables, segment
aggregates and embedding bags."""
