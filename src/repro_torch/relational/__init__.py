"""Sorted-table primitives on torch tensors."""
