"""Carry a plan built by the JAX package across to the port.

``plan_from_reference(plan, device)`` takes the dict that
``spmv_tpu.handle._build_plan`` returns and places it as the port's plan,
so the port's executor (``handle._make_bound``) runs on exactly the JAX
package's packed stream.  Every array goes through ``np.asarray``; this
module imports nothing of JAX.  bf16 arrays (``ml_dtypes.bfloat16`` there)
are read as their uint16 bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .formats.dia import DiaMatrix
from .formats.sell8d import Sell8D
from .formats.sell8w import Sell8WV2
from .handle import _not_ported, _place

__all__ = ["plan_from_reference"]

_ARRAYS = ("rest_rows", "rest_cols", "rest_vals", "fold_rows",
           "mega_sub_rows", "rows", "colidx", "vals")
_OUT_OF_SLICE = {"graph": 2, "sell8d_stripes": 3, "sell8w_v2w": 3,
                 "coo2": 4, "colidx_pad": 5, "blocks": 5, "cols": 5}


def _host_array(v) -> np.ndarray:
    a = np.asarray(v)
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
    if "data3_lo" in parts:
        raise _not_ported("the f64 DIA plan (K4)", 1)
    m = int(parts["m"])
    offsets = np.asarray(parts["offsets"], dtype=np.int32)
    data = _host_array(parts["data3"]).reshape(len(offsets), -1)[:, :m]
    return DiaMatrix(m, int(parts["n"]), int(np.count_nonzero(data)),
                     offsets, np.ascontiguousarray(data))


def _host_plan(p: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in p.items():
        if k in _OUT_OF_SLICE:
            raise _not_ported(f"the reference plan key {k!r}",
                              _OUT_OF_SLICE[k])
        if k == "hybrid":
            out[k] = tuple(_host_plan(q) for q in v)
        elif k == "sell8w_v2":
            out[k] = _dataclass_like(Sell8WV2, v)
        elif k == "sell8d":
            out[k] = _dataclass_like(Sell8D, v)
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

