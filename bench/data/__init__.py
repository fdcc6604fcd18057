"""Frozen copies of the input generators the configurations name.

The port's own copies (``repro_torch.data``) may change in a later PR; the
benchmark's inputs must not move with them.
"""
