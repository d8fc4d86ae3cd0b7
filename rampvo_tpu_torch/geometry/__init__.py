"""Projective geometry for the patch graph (port of rampvo_tpu/geometry)."""

from .projective import (
    MIN_DEPTH,
    coords_grid_with_index,
    extract_intrinsics,
    flow_mag,
    iproj,
    point_cloud,
    proj,
    relative_poses,
    set_depth,
    transform,
)

__all__ = [
    "MIN_DEPTH", "coords_grid_with_index", "extract_intrinsics", "flow_mag",
    "iproj", "point_cloud", "proj", "relative_poses", "set_depth", "transform",
]
