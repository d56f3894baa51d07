"""Multi-device execution layer (mesh row- and column-partitioned SpMV),
the port of ``spmv_tpu.parallel``: the mesh plans (``mesh``), driven by
one process or by one controller a ``torch.distributed`` rank
(``multihost``)."""

from . import multihost

from .mesh import (DistSpmvPlan, build_dist_plan, dist_spmv,
                   DistDiaPlan, build_dist_dia_plan, dist_dia_spmv,
                   DistSell8WPlan, build_dist_sell8w_plan, dist_sell8w_spmv,
                   DistSell8DPlan, build_dist_sell8d_plan, dist_sell8d_spmv,
                   DistSell8DColsPlan, build_dist_sell8d_cols_plan,
                   dist_sell8d_cols_spmv,
                   DistAutoPlan, build_dist_auto, dist_auto_spmv,
                   make_mesh_1d)

__all__ = ["DistSpmvPlan", "build_dist_plan", "dist_spmv",
           "DistDiaPlan", "build_dist_dia_plan", "dist_dia_spmv",
           "DistSell8WPlan", "build_dist_sell8w_plan", "dist_sell8w_spmv",
           "DistSell8DPlan", "build_dist_sell8d_plan", "dist_sell8d_spmv",
           "DistSell8DColsPlan", "build_dist_sell8d_cols_plan",
           "dist_sell8d_cols_spmv",
           "DistAutoPlan", "build_dist_auto", "dist_auto_spmv",
           "make_mesh_1d"]
