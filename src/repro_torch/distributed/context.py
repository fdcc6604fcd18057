"""Mesh context: lets deeply-nested layers opt into explicit collective
regions without threading the mesh through every config."""

from __future__ import annotations

import contextlib

_MESH = None
_DP_AXES = ("data",)


def get_mesh():
    return _MESH


def get_dp_axes():
    return _DP_AXES


@contextlib.contextmanager
def mesh_context(mesh, dp_axes=("data",)):
    global _MESH, _DP_AXES
    old, old_dp = _MESH, _DP_AXES
    _MESH, _DP_AXES = mesh, tuple(dp_axes)
    try:
        yield
    finally:
        _MESH, _DP_AXES = old, old_dp
