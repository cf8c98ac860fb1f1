from omnifusion_torch.projection.spec import (
    Equi2PersGrids,
    Pers2EquiGrids,
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
)
from omnifusion_torch.projection.ops import equi2pers, pers2equi_cf

__all__ = [
    "ProjectionSpec",
    "Equi2PersGrids",
    "Pers2EquiGrids",
    "build_equi2pers_grids",
    "build_pers2equi_grids",
    "equi2pers",
    "pers2equi_cf",
]
