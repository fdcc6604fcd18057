"""Mesh context: lets deeply-nested layers opt into explicit collective
regions without threading the mesh through every config.

``mesh_context`` selects the explicit expert-parallel MoE.  ``data_group``
is set by the sharded train step (``train.step.make_sharded_train_step``)
around its forward and backward: each rank then holds one data block of
the batch, and the dense MoE takes its load-balance statistics over the
whole batch, as the reference's GSPMD step does."""

from __future__ import annotations

import contextlib

_MESH = None
_DP_AXES = ("data",)
_DATA_GROUP = None


def get_mesh():
    return _MESH


def get_dp_axes():
    return _DP_AXES


def get_data_group():
    return _DATA_GROUP


@contextlib.contextmanager
def mesh_context(mesh, dp_axes=("data",)):
    global _MESH, _DP_AXES
    old, old_dp = _MESH, _DP_AXES
    _MESH, _DP_AXES = mesh, tuple(dp_axes)
    try:
        yield
    finally:
        _MESH, _DP_AXES = old, old_dp


@contextlib.contextmanager
def data_group(group):
    global _DATA_GROUP
    old = _DATA_GROUP
    _DATA_GROUP = group
    try:
        yield
    finally:
        _DATA_GROUP = old
