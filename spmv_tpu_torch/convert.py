"""Carry a plan built by the JAX package across to the port.

``plan_from_reference(plan, device)`` takes the dict that
``spmv_tpu.handle._build_plan`` returns (any of its plans: the SELL tile
plans, the graph plan, COO2, DIA, and the XLA plans) and places it as the
port's plan, so the port's executor (``handle._make_bound``) runs on
exactly the JAX package's packed stream.  ``dist_plan_from_reference(plan, mesh)`` does the
same for a mesh plan of ``spmv_tpu.parallel``: it reads the plan's stacked
``(ndev, ...)`` arrays and places shard d on ``mesh.devices[d]``.  Every
array is copied to the host with ``np.array``; this module imports nothing
of JAX.
bf16 arrays (``ml_dtypes.bfloat16`` there) are read as their uint16 bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .formats.coo2 import Coo2
from .formats.dia import DiaMatrix
from .formats.sell8d import Sell8D
from .formats.sell8w import Sell8W, Sell8WV2
from .handle import _place
from .utils.profiling import dev_put

__all__ = ["plan_from_reference", "dist_plan_from_reference"]

_ARRAYS = ("rest_rows", "rest_cols", "rest_vals", "fold_rows",
           "mega_sub_rows", "rows", "colidx", "vals", "hub_cols",
           "colidx_pad", "vals_pad", "row_start", "row_end", "vrow_start",
           "vrow_end", "sub_start", "sub_end", "cols", "chunk_ids",
           "inv_pos", "blocks", "block_rows", "block_cols")


def _host_array(v) -> np.ndarray:
    a = np.array(v)                 # a writable host copy
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _dataclass_like(cls, obj):
    """An instance of the port's ``cls`` with ``obj``'s fields, by name."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = _host_array(v) if hasattr(v, "shape") else v
    return cls(**kw)


def _dia_from_parts(parts) -> DiaMatrix:
    """The Pallas DIA plan's parts; an f64 plan's (hi, lo) f32 planes
    become one f64 plane, hi + lo."""
    m = int(parts["m"])
    offsets = np.asarray(parts["offsets"], dtype=np.int32)
    data = _host_array(parts["data3"])
    if "data3_lo" in parts:
        data = (data.astype(np.float64)
                + np.asarray(parts["data3_lo"], dtype=np.float64))
    data = data.reshape(len(offsets), -1)[:, :m]
    return DiaMatrix(m, int(parts["n"]), int(np.count_nonzero(data)),
                     offsets, np.ascontiguousarray(data))


def _host_plan(p: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in p.items():
        if k == "hybrid":
            out[k] = tuple(_host_plan(q) for q in v)
        elif k in ("light", "heavy"):       # a graph plan's parts
            out[k] = _host_plan(v)
        elif k in ("sell8w_v2", "sell8w_v2w"):
            out[k] = _dataclass_like(Sell8WV2, v)
        elif k == "sell8d":
            out[k] = _dataclass_like(Sell8D, v)
        elif k == "sell8d_stripes":
            out[k] = [(int(lo), int(hi), np.asarray(vis, dtype=np.int64),
                       _dataclass_like(Sell8D, pk))
                      for lo, hi, vis, pk in v]
        elif k == "coo2":
            out[k] = dataclasses.replace(
                _dataclass_like(Coo2, v),
                reduce_plan=_dataclass_like(Sell8W, v.reduce_plan))
        elif k == "dia_pallas":
            out["dia"] = _dia_from_parts(v)
        elif k == "data":           # the XLA DIA plan
            data = _host_array(v)
            out["dia"] = DiaMatrix(
                data.shape[1], int(p["n"]), int(np.count_nonzero(data)),
                np.asarray(p["offsets"], dtype=np.int32),
                np.ascontiguousarray(data))
        elif k in _ARRAYS:
            out[k] = _host_array(v)
        elif k == "sell8w":
            continue                # the v1 pack: host-only, unused
        else:
            out[k] = v
    return out


def plan_from_reference(plan: Dict[str, Any], device) -> Dict[str, Any]:
    """The JAX package's plan dict → the port's plan, placed on
    ``device``."""
    return _place(_host_plan(plan), device)


#: mesh plan class → (its static fields, its stacked arrays, the port's
#: placement); a name with a leading underscore is read from the JAX plan
#: under that name and handed on without it
_DIST = {
    "DistSpmvPlan": (("m", "n", "nnz", "tile", "mr", "row_splitter",
                      "x_mode", "identity_out", "loc_tile", "_halo"),
                     ("colidx_pad", "vals_pad", "row_start", "row_end",
                      "out_index", "loc_colidx", "loc_vals",
                      "loc_row_start", "loc_row_end", "_in_index"),
                     "_place_scan"),
    "DistDiaPlan": (("m", "n", "nnz", "offsets", "mr", "x_mode"), ("data",),
                    "_place_dia"),
    "DistSell8WPlan": (("m", "n", "nnz", "mr", "ntiles", "nslices",
                        "x_mode", "max_pad", "_halo"),
                       ("window_ids", "gpk", "meta", "vals", "vals_lo"),
                       "_place_sell8w"),
    "DistSell8DPlan": (("m", "n", "nnz", "mr", "ntiles", "nsteps",
                        "nslices", "g", "nw", "value_mode", "x_mode",
                        "max_pad", "rest", "_halo"),
                       ("tinfo", "ginfo", "meta", "vals", "vals_lo", "pal",
                        "pal_lo"), "_place_sell8d"),
    "DistSell8DColsPlan": (("m", "n", "nnz", "cw", "ntiles", "nsteps",
                            "nslices", "g", "nw", "value_mode", "max_pad",
                            "rest"),
                           ("tinfo", "ginfo", "meta", "vals", "vals_lo",
                            "pal", "pal_lo"), "_place_sell8d_cols"),
}


def dist_plan_from_reference(plan, mesh):
    """A ``spmv_tpu.parallel`` mesh plan → the port's plan of the same
    kind on ``mesh`` (as many entries as the plan has shards), running on
    exactly the JAX plan's packed arrays.  A ``DistAutoPlan`` carries its
    parts, fold rows, hub columns and straggler stream across."""
    from .parallel import mesh as pm
    kind = type(plan).__name__
    if kind == "DistAutoPlan":
        dev0 = mesh.home
        parts = {}
        for k, v in plan.parts.items():
            parts[k] = (dist_plan_from_reference(v, mesh)
                        if type(v).__name__ in _DIST
                        else dev_put(_host_array(v).astype(np.int64), dev0))
        return pm.DistAutoPlan(
            kind=plan.kind, x_mode=plan.x_mode, m=plan.m, n=plan.n,
            nnz=plan.nnz, parts=parts, value_mode=plan.value_mode,
            max_pad=plan.max_pad, rest=pm._place_rest(
                mesh, None if plan.rest is None
                else tuple(_host_array(r) for r in plan.rest)))
    if kind not in _DIST:
        raise TypeError(f"not a mesh plan of spmv_tpu.parallel: {kind}")
    static_names, array_names, place = _DIST[kind]
    if plan.ndev != len(mesh.devices):
        raise ValueError(f"the plan has {plan.ndev} shards, the mesh "
                         f"{len(mesh.devices)} devices")
    static = {k.lstrip("_"): getattr(plan, k, 0) for k in static_names}
    if static.get("rest") is not None:
        static["rest"] = tuple(_host_array(r) for r in static["rest"])
    arrays = {}
    for k in array_names:
        v = getattr(plan, k, None)
        arrays[k.lstrip("_")] = None if v is None else _host_array(v)
    return getattr(pm, place)(mesh, mesh.axis, static, arrays)
