from omnifusion_torch.projection.spec import (
    Equi2PersGrids,
    Pers2EquiGrids,
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)
from omnifusion_torch.projection.ops import (
    PatchProjection,
    equi2pers,
    equi2pers_full,
    pers2equi,
    pers2equi_cf,
    project,
    unproject,
)
from omnifusion_torch.projection.perspective import extract_views, insert_views

__all__ = [
    "ProjectionSpec",
    "Equi2PersGrids",
    "Pers2EquiGrids",
    "PatchProjection",
    "build_equi2pers_grids",
    "build_pers2equi_grids",
    "equi2pers",
    "equi2pers_full",
    "pers2equi",
    "pers2equi_cf",
    "project",
    "unproject",
    "extract_views",
    "insert_views",
]
