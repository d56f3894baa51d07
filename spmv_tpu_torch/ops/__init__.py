"""Execution: the hand-written Hopper kernels (with their plain PyTorch
versions) and the plain PyTorch plans.

Written once here: the launch protocol of every kernel wrapper
(:func:`kernel`; the probe kernels take its device switch,
:func:`require_cpu`), the per-CUDA-stream tickets (:func:`tickets`), the
stream kind of each plan key (:data:`KINDS`, which ``handle.py`` places,
binds and names plans by), and the one seam where a hybrid's part takes a
layout of the card's own (:func:`card_layout`, by :func:`use_card_layout`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch

from ..utils.profiling import live, opening

__all__ = ["kernel", "require_cpu", "tickets", "Kind", "KINDS",
           "card_layout", "use_card_layout", "sell_bytes", "TILE_BYTES"]


def require_cpu(op: str, device: torch.device) -> None:
    """The device switch of every kernel wrapper off the card: the CPU
    runs the plain version; any other device raises."""
    if device.type != "cpu":
        raise ValueError(f"{op}: no kernel for device {device}")


def kernel(op: str, plain: Callable) -> Callable:
    """The decorator that makes the wrapper ``op(st, x)`` from
    ``launch(st, x, stream) -> y`` (``stream``: the current CUDA stream's
    handle; it launches by ``_build.launch``): each call inside the span
    ``spmv.kernel.<st.kernel>`` while spans are live; a CPU x takes
    ``plain(st, x)``, any other device but CUDA raises; a CUDA x must be a
    contiguous ``st.dtype`` ``(st.n,)`` tensor on ``st.device``."""
    def wrap(launch: Callable) -> Callable:
        @functools.wraps(launch)
        def call(st, x):
            if live():
                s = opening("spmv.kernel." + st.kernel)
                if s is not None:
                    with s:
                        return call(st, x)
            if x.device.type != "cuda":
                require_cpu(op, x.device)
                return plain(st, x)
            if (x.dtype != st.dtype or x.shape != (st.n,)
                    or not x.is_contiguous() or x.device != st.device):
                raise ValueError(
                    f"{op}: x must be a contiguous {st.dtype} ({st.n},) "
                    f"tensor on {st.device}, got {x.dtype} "
                    f"{tuple(x.shape)} on {x.device}")
            return launch(st, x,
                          torch.cuda.current_stream(x.device).cuda_stream)
        return call
    return wrap


def tickets(st, key) -> torch.Tensor:
    """The ticket counters of launches over ``st`` (a SELL or a K13
    stream) on the CUDA stream ``key`` = (device index, cuda_stream):
    ``st.ntickets`` int32 zeros, made on the key's first use on the
    current CUDA stream (the launch's, so the fill is ordered before it),
    kept in ``st.tickets_by_stream`` while ``st`` lives."""
    t = st.tickets_by_stream.get(key)
    if t is None:
        t = st.tickets_by_stream[key] = torch.zeros(
            st.ntickets, dtype=torch.int32, device=st.device)
    return t


#: bytes of one f32 SELL tile, of SELL-8W or SELL-8D: (8, 128) slots of
#: int16 meta and f32 value
TILE_BYTES = 8 * 128 * (2 + 4)


def sell_bytes(tiles: int) -> int:
    """The bytes of an f32 SELL stream of ``tiles`` tiles."""
    return int(tiles) * TILE_BYTES


def use_card_layout(device_type: Optional[str], value_mode: str,
                    sell_tiles: int, layout_bytes: int) -> bool:
    """Whether a hybrid's part takes the card's layout with explicit
    columns (K12 light, K13 heavy) in place of its SELL stream: on CUDA,
    for f32 values (a palette, bf16 or double-float stream keeps its
    narrower values), where the SELL stream's bytes are at least twice
    the layout's."""
    return (device_type == "cuda" and value_mode == "f32"
            and sell_bytes(sell_tiles) >= 2 * layout_bytes)


# the kernels' modules import the protocol above
from . import coo2, csr_split, dia, sell, sell_cs, torch_csr  # noqa: E402
from ..formats import (csr_split as _csr_split_fmt,  # noqa: E402
                       sell_cs as _sell_cs_fmt)
from ..formats.sell8d import slot_value_mode  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Kind:
    """A kernel stream's kind: ``prepare(pack, device) -> st`` and
    ``product(st, x) -> y``, which gives whole output blocks where ``cut``
    (cut to ``st.m``); ``short``, its name in ``hybrid(<heavy>+<light>)``;
    for a card layout, the hybrid ``part`` it may take (by
    :func:`use_card_layout`), its ``pack(rows)`` and
    ``layout_bytes(row_lengths)``; ``info(st)``, what ``describe`` says."""

    prepare: Callable
    product: Callable
    cut: bool = False
    short: Optional[str] = None
    part: Optional[str] = None
    pack: Optional[Callable] = None
    layout_bytes: Optional[Callable] = None
    info: Optional[Callable] = None


_slot = functools.partial(sell.prepare_sell, slot_mode=True)
_row = functools.partial(sell.prepare_sell, slot_mode=False)

#: plan key → its stream kind (a graph plan's parts and a hybrid's parts
#: hold these keys too; ``sell8d_stripes`` is bound by ``handle.py``)
KINDS: Dict[str, Kind] = {
    "sell8d": Kind(_slot, sell.sell_spmv, cut=True, short="8d"),
    "sell8w_v2": Kind(_row, sell.sell_spmv, cut=True, short="8w"),
    "sell8w_v2w": Kind(_row, sell.sell_spmv, cut=True, short="8w"),
    "sell_cs": Kind(sell_cs.prepare_cs, sell_cs.cs_spmv, short="cs",
                    part="light", pack=_sell_cs_fmt.pack_sell_cs,
                    layout_bytes=_sell_cs_fmt.layout_bytes),
    "csr_split": Kind(csr_split.prepare_split, csr_split.split_spmv,
                      short="split", part="heavy",
                      pack=_csr_split_fmt.pack_csr_split,
                      layout_bytes=_csr_split_fmt.layout_bytes,
                      info=csr_split.describe),
    "dia": Kind(dia.prepare_dia, dia.dia_spmv),
    "coo2": Kind(coo2.prepare_coo2, coo2.coo2_spmv),
}


def card_layout(part: str, device_type: Optional[str], rows, sell_tiles: int,
                nw: int, df: bool) -> Optional[Dict[str, Any]]:
    """The plan of a hybrid's ``part`` ("heavy" or "light"), the matrix
    ``rows``, in the card's layout for it where :func:`use_card_layout`
    takes it over its SELL stream of ``sell_tiles`` tiles (values read at
    ``nw`` windows, f64 where ``df``); else None (it keeps SELL)."""
    mode = slot_value_mode(rows.vals, nw, df)
    for key, kind in KINDS.items():
        if kind.part == part and use_card_layout(
                device_type, mode, sell_tiles,
                kind.layout_bytes(rows.row_lengths)):
            return {key: kind.pack(rows), "value_mode": "f32"}
    return None
