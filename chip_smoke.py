#!/usr/bin/env python3
"""Drive the port's f32 and f64 AUTO main paths (the graph plan among them),
its bf16 matrices, its Method.CSR5 path, its large-n path (n > 2M: column stripes and
windowed streams), the planner's calibration (the probes, the price table
they give, the routes under it), its plain plans (the ones the JAX package
runs through XLA), its mesh plans (``spmv_tpu_torch.parallel``) in one process and on
two ranks (``parallel.multihost``), its execute-many layer (``tune``,
the solvers, the CSV suite, Matrix Market I/O) and its headline bench
(``bench_torch.py``) on one NVIDIA card and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

(The multihost phase starts this script twice more, as
``chip_smoke.py --multihost-rank RANK PORT DIR``, one rank process each.)

Phases (any failure exits non-zero and prints no ``"ok"`` line).  Every
handle and mesh plan the script builds is called three times on one x,
and the three ys must agree bit for bit: the port's sums have a fixed
order on the card.  The streams check calls the handles of clustered200k,
powerlaw100k, clustered200k_f64 and tridiag2500k_sell (main path) and the
mesh plan of webbase1m_dist4 (dist path) on two CUDA streams at once, 50
rounds of two calls a stream held behind one gate, x and x reversed in
turns, every y bit for bit its x's one-stream y (each SELL stream keeps
its ticket counters a CUDA stream); lines ``{"phase": "streams", ...}``.


1. toolchain: the card's name and power limit, CUDA, nvcc, triton;
2. build: the host packers (g++) and the CUDA kernels (nvcc, sm_90a, one
   process per source), with ptxas' registers and spill bytes, and
   ``window_gather``'s step loop in ``cuobjdump -sass``: it must issue
   every slot's shared-memory loads each step (64 ``LDS`` an iteration in
   the loop form, 48 in the wide form); ``tiny`` and ``fma_err`` must
   carry ``ACQBULK`` (what ``griddepcontrol.wait`` lowers to) before their
   first global load, and ``PREEXIT`` (the dependents' trigger);
3. kernels: each kernel against its plain PyTorch version on the card —
   ``sell_row`` over f32/bf16/palette values, ``sell_slot`` over
   nw ∈ {1,2,4,8} × cell_w × the three value modes, ``dia`` over f32/bf16,
   and their f64 forms ``sell_row_df``, ``sell_slot_df`` (df, df16,
   palette_df, the same nw × cell_w grid) and ``dia_f64``; the COO2
   kernels ``coo2_pass1`` (f32 and bf16 values, n ≡ 0, 1, 2, 3 mod 4, an
   inf at a column a padding slot reads and one past the staged 16-B
   words of the last window, one stream launched 1,000 times) and
   ``sell_row_bin`` (one stream over more than 2M product positions); and
   the same SELL grid
   past 2M columns (n = 2.5M), which names the windowed kernels
   ``sell_row_w`` (K5 values), ``sell_slot_w`` (K6), ``sell_row_df_w`` and
   ``sell_slot_df_w`` (K7); and the v1 kernels on full-size v1 packs
   (clustered200k's ``pack_sell8w``): ``sell_v1`` (K9), ``sell_v1_df``
   (K10, the pack twice, hi and lo), ``sell_v1_bin`` (K11, validity in meta
   bit 15), and ``sell_v1`` on one stream at n = 2.5M;
3a. sell_cs: K12, the row-split hybrid's light rows in SELL-32-σ with
   explicit columns, on two handles that AUTO must plan as
   ``hybrid(split+cs)`` on the card: a 20,000-row power-law matrix with
   gaussian f32 values and Graph500 SCALE 19's PageRank matrix as the
   benchmark's ``graph500-s19`` cell draws it (``spmvbench``'s Kronecker
   generator on the card, seed 1).  Per handle: one counted product that
   must launch ``sell_cs`` and ``csr_split`` once each and neither
   ``sell_row`` nor ``sell_slot``; K12
   against its plain version (and the number of positions whose bits
   differ), and with an inf at x[0], which padding slots read: NaN where
   the plain version has NaN; K12 and the handle 20 calls each bit for
   bit; the product against ``spmv_golden``.  On the graph also: the
   layout's slots, bytes and padding beside the SELL-8D stream that the
   CPU's route packs for the same light rows (its tiles and bytes) and the
   heavy part's, K12 timed (warm, cold, device) beside that slot stream
   and cuSPARSE on the same rows, and the two whole products in turns;
   lines ``{"phase": "sell_cs", ...}``;
3b. csr_split: K13, the same handles' heavy rows in row-split CSR with
   explicit columns: K13 against its plain version bit for bit, K13 20
   calls bit for bit, the plan's ``describe`` (pieces, rows split); on the
   graph K13 timed (warm, cold, device) beside K1 row on the SELL-8W
   stream the CPU's route packs for the same rows and cuSPARSE on them,
   and the same rows packed at P 512 (more rows split, more tickets)
   bit for bit their plain version; lines ``{"phase": "csr_split", ...}``;
4. main path: the bench's nine families (``bench.py``'s generator calls
   and seeds, ``_to_f64`` seed 7 for the f64 ones) through
   ``create_handle(a, device="cuda")`` and ``spmv``, with the AUTO plan
   asserted (webbase1m: the graph plan, its heavy rows on ``sell_row``, its
   light rows on ``sell_slot`` over x extended by the hub columns and the
   heavy output), and three CSR5 families: clustered200k with ``Method.CSR5``
   (the two-pass COO2 plan), clustered200k at spread 4096 with AUTO, which
   must resolve to ``Method.CSR5`` and COO2, and clustered200k_f64 with
   ``Method.CSR5`` (the SELL-8D df16 retry); each COO2 pack must come from
   the native packer; and the large-n path: clustered2500k_s64 and its
   f64 form and uniform250k_4m_d64 (AUTO: column stripes, each stripe a
   resident stream), and tridiag2500k_sell (``Method.SELL_C_SIGMA``: one
   windowed slot stream); and the plain run, each family with its plan
   and resolved method asserted: powerlaw100k under ``Method.BALANCED``,
   ``BALANCED_YID`` and ``BALANCED2`` (the tiled scan, the global scan, the
   mega-row split) and its f64 form under ``BALANCED2`` (it must not
   demote), uniform100k under ``SELL_C_SIGMA`` with ``VectorizedWay.NONE``
   (the chunked SELL), ``block_random(512, 512, 4, fill 0.4)`` under AUTO
   (BCSR; run once more with TF32 switched on for every matmul, which must
   not move it past its bound) and a 200k band scrambled by a symmetric
   permutation under AUTO with ``reorder="rcm"`` (DIA, ``dia``; the
   reorder's host seconds are logged).  The f32 AUTO path, the f64 AUTO
   path, the CSR5 path, the large-n path and the plain run each run once
   with every launch count set to 0 just before and read just after, and
   each family's kernels must have launched.  Then
   per family: the result against its reference, CUDA-event times of the
   port, of the same plan on the plain versions and of one cuSPARSE call
   (``torch.sparse_csr_tensor(...) @ x``, timed only: the port never
   calls it), a torch.profiler window, and each kernel against its plain
   version at the main path's shapes, with its bound;
4a. folds: the two folds of repeated rows (``torch_csr.fold_add``) at
   powerlaw100k's size, which no family's plan takes: its mega-row
   sub-rows folded into their rows and a mesh plan's straggler rows over
   every nonzero of those rows, f32 and f64, three calls bit for bit, each
   against ``index_add_`` in f64 on the CPU, timed beside the
   ``index_add_`` it replaced (``{"phase": "folds", ...}`` lines);
4b. bf16: six main-path matrices rounded to bf16
   (``CsrMatrix.astype(torch.bfloat16)``) through AUTO, each with the
   route the JAX planner gives bf16 asserted (the tile routes are f32/f64
   only): banded4m (DIA, ``dia`` on bf16 diagonals), clustered200k and
   uniform100k (the chunked SELL-C-σ), powerlaw100k (``SELL_C_SIGMA``
   falling back to the tiled scan), webbase1m (a plain plan, logged) and
   block512_bcsr (BCSR), and powerlaw100k through ``build_dist_auto`` on
   4 entries of ``cuda:0`` (the scan).  One counted run (every count 0
   before, read after) must launch ``dia``.  Per family: the route, y (f32)
   against ``spmv_golden`` of the decoded matrix (1e-5, the scans' absolute
   term), ms a call, device ms and idle share, beside the f32 handle's ms a
   call and cuSPARSE's in f32; banded4m's y and plan bytes must equal its
   f32 handle's bit for bit (the dyadic band's f32 plan already streams
   lossless bf16 diagonals); lines ``{"phase": "bf16", ...}``;
5. prices: the planner's calibration (``spmv_tpu_torch/bench/probes.py``,
   ``formats/prices.py``).  One counted run of the nine probes P1-P9 on
   the main path's clustered200k (``pack_sell8w(max_pad_ratio=3.0)``,
   ``plan_v2(g=16)``) and P9's own arrays, which must launch each probe
   kernel (``tile_stream``, ``tile_body``, ``window_gather``, ``tiny``,
   ``fma_err``), each figure on a line under the JAX probe's field names;
   each probe kernel against its plain version on every input its probes
   give it (f32 sums within 1e-5 of the sum of magnitudes; ``tiny`` and
   ``fma_err`` bit for bit, ``fma_err`` also equal to the exact product
   error, ``tiny``'s chains of 100 launches from C with and without
   programmatic dependent launch bit for bit v·2^100, 20 chains each;
   ``tiny`` and ``fma_err`` one call, device time and the host's µs a
   call, and ``tiny``'s chains' ms a launch with the card held until the
   host has queued them; ``tile_stream``, ``tile_body`` and both forms of
   ``window_gather`` three calls bit for bit, ``tile_stream`` and
   ``window_gather`` bit for bit the numpy statements of their orders,
   ``window_gather`` also within 1e-5 of the numpy oracle), with
   ``tile_stream`` at B = 1, 8, 64, 512 beside ``torch.sum``, each
   ``tile_body`` input (P5's full body also at G 8) and both forms of
   ``window_gather`` (g 32, 2,048 steps; its bound the adds of every
   tile-gather) timed warm and with the L2 cold (``sweep`` lines); the
   real kernels' co-timings (the slot kernel on uniform100k and its f64
   form at nw 1-8, the windowed slot kernel on the first 625,000 rows of
   clustered2500k_s64 at nw 1-8,
   the row kernel on clustered200k in f32, df16 and df, webbase1m's light
   part at g 8 and 16, its straggler stream in f32 and f64, its hub gather
   and fold); the table ``derive_prices`` makes of them beside the
   committed ``H100`` and ``REFERENCE``, with the drift (not a failure);
   then the North star's nine families and the three striped large-n
   families planned under ``H100`` beside their main-path plan, each
   route printed; where the routes differ, both y against the family's reference and bound, and
   both timed in turns (CUDA events, median of 30, and a profile each);
6. windowed forms: each striped family packed as one windowed slot stream
   (as the JAX planner packs it when its gate vetoes the stripes), and
   clustered2500k_s64 and its f64 form packed as a ``sell8w_v2w`` row
   stream, each against the family's reference, each stream against its
   plain version with its bound, and each timed beside the striped plan
   of the same matrix, per call and on the card;
7. dist path: ten mesh families through ``spmv_tpu_torch.parallel`` on a
   mesh of N entries of ``cuda:0`` ("distN"), ``build_dist_auto`` (or
   ``build_dist_sell8w_plan`` where the name says ``8w``) with the plan
   kind and x mode asserted: webbase1m on 1 and 4 shards (graph: heavy
   rows on ``sell_v1``, light rows on ``sell_slot``), powerlaw100k and its
   f64 form on 1 shard (hybrid: ``sell_v1`` / ``sell_v1_df`` beside the
   slot stream), clustered200k as SELL-8W on 4 shards (allgather,
   ``sell_v1``; f64 halo, ``sell_v1_df``), clustered200k on 4 shards
   (SELL-8D, halo), banded1m_f64 (DIA, halo: plain PyTorch, as the JAX
   package runs XLA there), powerlaw100k on 4 shards (the tiled scan,
   plain PyTorch) and uniform250k_4m_d64 (column shards and one sum).  One
   counted run (every count 0 before, read after) must launch each
   family's kernels, ``sell_v1`` and ``sell_v1_df`` among them.  Per
   family: the result against its reference, every shard stream against
   its plain version, CUDA-event times of the mesh plan beside the
   single-device AUTO plan of the same matrix (what sharding costs on one
   card; in turns: mesh, single, single, mesh), cuSPARSE, and a
   torch.profiler window;
8. multihost: the seven 4-shard dist families on two rank processes of
   two shards each (``init_distributed(backend="gloo")``,
   ``global_mesh_1d(device="cuda:0", local_shards=2)``: one card cannot
   hold two NCCL ranks, so this times the host staging of the collectives,
   not NCCL), each planned on every rank with its kind and x mode
   asserted, run once with every count 0 before and read after on the
   rank (its kernels must launch on both ranks: ``sell_v1``,
   ``sell_v1_df``, ``sell_slot``), its y bit for bit the dist phase's and
   within its bound of the reference; per family the median of 30 calls
   after 3 (CUDA events, a barrier before each) on each rank beside the
   single-controller plan's, the bytes a call moves between the ranks
   and one gloo all-gather of as many host bytes; the dist plans are freed
   first, so three processes fit on the card;
9. tools: the execute-many layer through its entry points on ``cuda:0``,
   as one counted run that must launch ``sell_slot``, ``dia`` and
   ``dia_f64``: ``tune(uniform100k)`` with the default candidates (each
   candidate's time a SpMV and plan, or its refusal; the winner the
   minimum and within 1e-5 of ``spmv_golden``; a second call a cache hit
   that builds only the winner); ``cg`` in f64 on HPCG's reference
   problem (the 27-point stencil on hpcg.dat's 104³ grid, 1,124,864 rows,
   29,791,000 nonzeros), 50 iterations at tol 0, on the DIA plan AUTO
   must pick, its residual within 1e-6 of the same recurrence in numpy
   f64 on the host and of ‖b − A x‖ there; ``bicgstab`` in f32 on
   ``diag_plus_random(1M, 6)`` to 1e-5·‖b‖ (converged, ‖b − A x‖ on the
   host within twice that); ``power_iteration`` on clustered200k, 100
   iterations, λ within 1e-5 of the host's Rayleigh quotient of the
   returned v; each solve's time an iteration beside one ``spmv`` on the
   same handle, its host reads and a profile window; ``bench_matrix`` on
   builtin banded1m and uniform100k with AUTO, CSR5, SERIAL and the
   ScipyCsr/TorchCsr yardsticks, each row's rmse within 1e-5 of the rms
   of (|A||x|)_i, beside ``time_spmv_chain``'s inclusive time and one
   ``spmv`` of the AUTO handle and the chain with the SpMV replaced by
   identity (the renormalisation's own cost); and a Matrix Market round
   trip of clustered200k (``write_mtx``, ``read_mtx`` through the C++
   parser, which must run, and the numpy path, ``load_matrix`` twice, the
   second a cache hit), every array equal to the matrix's.  Each line
   names the card;
10. bench: ``python3 bench_torch.py`` as a process of its own (the nine
   families planned with AUTO, its own pre-deal, the chained protocol in
   two windows 15 s apart); its last line must parse and hold all nine
   families, each with GF/s above 0 and none failed; lines ``{"phase":
   "bench", ...}`` with the line, each family's fields, its two windows
   and their spread, and the phase's wall seconds.

Bounds, per row i against (|A||x|)_i:
- f32: 1e-5 against ``spmv_golden``; f32 sums in another order.
- f64 family: 1e-10 against row-by-row f64 sums of the products
  (``np.add.reduceat``).  df16 values carry ≤ 2^-39 relative error, and an
  f32 computation (~1e-7) fails it.  ``spmv_golden`` takes its rows as
  differences of one running f64 sum, whose rounding reaches 4e-9 of
  (|A||x|)_i on powerlaw100k_f64, so the f64 families are held to the
  row-by-row sums and the distance to ``spmv_golden`` is printed beside.
- f64 kernel against its plain version: 1e-12; both are f64 sums of the
  same decoded values, taken in another order.
- ``coo2_pass1`` against its plain version: bit for bit, NaN where the
  plain version has NaN; each is one f32 product a slot, rounded once.
- the f32 scans (the dist scan, Balanced, BalancedYid, Balanced2): 1e-5
  plus an absolute term, the JAX dist test's 2e-4 at 150k nonzeros scaled
  by sqrt(nonzeros of the largest shard, or of the matrix, / 150k): the
  f32 prefix sums carry about eps·sqrt(nnz) absolute error, which no row's
  (|A||x|)_i bounds.  The f64 scans (Balanced2 on powerlaw100k_f64): 1e-10
  plus tests/test_methods.py's f64 absolute term, 1e-10·max(max|y|, 1):
  the card's parallel prefix sum rounds two neighbouring prefixes apart,
  so even an empty row comes out a few ulps of the prefix off zero.

``bound_ms`` is the larger of the bytes the SpMV must move over 3.35 TB/s
and its operations over 67 TFLOP/s in f32 or 34 TFLOP/s in f64 (NVIDIA
H100 SXM data sheet): each nonzero value read once in the stream's own
encoding without padding, x read once, y written once at its real rows,
2 operations a nonzero.  The COO2 kernels count their own work: pass 1
reads each nonzero's meta and value and writes its product (1 operation);
the binary reduce reads each valid slot's meta, the product stream once
and writes y (1 addition a nonzero).  ``stream_bound_ms`` beside it
counts the packed stream as stored (padding slots, chunk tables, the
padded output): what the kernel's format makes it move.  Each kernel's
``library_ms`` is one cuSPARSE CSR product over the stream's own
nonzeros, except ``coo2_pass1``'s: ``x.take(cols) * vals`` over its
nonzeros, two PyTorch calls (``library_call`` names it).

Output: one JSON line per family, per windowed form, per multihost family
and per tool, one ``{"kernels": [...]}`` line (a kernel's numbers at its
largest stream of the main path or the windowed forms, its launches those
of the counted runs, the ranks' added),
the wall time, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
BOUND = 1e-5
BOUND_F64 = 1e-10
BOUND_F64_KERNEL = 1e-12
ITERS = 30
#: calls on one x whose ys must agree bit for bit (every handle and plan)
REPEAT_CALLS = 3
#: the families whose handle (or mesh plan) the streams check calls on two
#: CUDA streams at once: K1 slot (clustered200k: output blocks of several
#: chunks), K1 row + slot (powerlaw100k), K2 (clustered200k_f64), K6
#: (tridiag2500k_sell) and K9 (webbase1m_dist4's v1 shards)
STREAM_FAMILIES = ("clustered200k", "powerlaw100k", "clustered200k_f64",
                   "tridiag2500k_sell", "webbase1m_dist4")
#: rounds of the streams check, and calls a CUDA stream a round
STREAM_ROUNDS = 50
STREAM_CALLS = 2
#: L2 flushes (256 MB rewritten each, about 0.15 ms) that hold both CUDA
#: streams back each round while the host enqueues their calls
STREAM_GATE = 8
#: profile windows per measurement: device times are their median
WINDOWS = 5
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def _to_f64(a, np):
    """bench.py:_gen_one's ``_to_f64``: the same pattern, f64 values."""
    from spmv_tpu_torch.types import CsrMatrix
    vals = np.random.default_rng(7).standard_normal(a.nnz)
    return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, vals)


def _clustered200k(g, np, spread=512):
    """bench.py:_gen_one's clustered200k (at another spread if asked)."""
    return g.clustered(200_000, 200_000, 32, spread=spread,
                       dtype=np.float32, seed=9)


def _webbase1m(g, np):
    """bench.py:_gen_one's webbase1m."""
    return g.webbase_like(1_000_000, 1_000_000, 3_100_000, dtype=np.float32,
                          seed=11)


def _powerlaw100k(g, np):
    """bench.py:_gen_one's powerlaw100k."""
    return g.power_law(100_000, 100_000, 40 * 100_000, dtype=np.float32,
                       seed=2)


def _scrambled_band(g, np):
    """banded 200k (4 diagonals a side), rows and columns scrambled by one
    permutation: a band that only a reorder finds again."""
    from spmv_tpu_torch.formats.reorder import reorder_symmetric
    a = g.banded(200_000, 200_000, 4, dtype=np.float32, seed=7)
    return reorder_symmetric(a, np.random.default_rng(1)
                             .permutation(200_000))[0]


#: family → (generator call as in bench.py:_gen_one, the plan it must
#: build, its value mode, the kernels it runs); the method asked for is
#: AUTO unless CSR5_FAMILIES, LARGE_N_FAMILIES or PLAIN_FAMILIES name
#: another
FAMILIES = {
    "banded4m": (lambda g, np: g.banded(4_000_000, 4_000_000, 4,
                                        dtype=np.float32, seed=7),
                 "dia", None, ("dia",)),
    "clustered200k": (_clustered200k, "sell8d", "bf16", ("sell_slot",)),
    "uniform100k": (lambda g, np: g.random_uniform(100_000, 100_000, 40,
                                                   dtype=np.float32,
                                                   seed=42),
                    "sell8d", "bf16", ("sell_slot",)),
    "powerlaw100k": (_powerlaw100k, "hybrid(8w+8d)", "bf16",
                     ("sell_row", "sell_slot")),
    # the graph plan: hub columns appended to x, heavy rows on K1's row
    # mode, light rows on its slot mode
    "webbase1m": (_webbase1m, "graph", "palette", ("sell_row", "sell_slot")),
    "banded1m_f64": (lambda g, np: _to_f64(g.banded(
        1_000_000, 1_000_000, 4, dtype=np.float32, seed=7), np),
        "dia", None, ("dia_f64",)),
    "uniform100k_f64": (lambda g, np: _to_f64(g.random_uniform(
        100_000, 100_000, 40, dtype=np.float32, seed=42), np),
        "sell8d", "df16", ("sell_slot_df",)),
    "clustered200k_f64": (lambda g, np: _to_f64(_clustered200k(g, np),
                                                np),
                          "sell8d", "df16", ("sell_slot_df",)),
    "powerlaw100k_f64": (lambda g, np: _to_f64(g.power_law(
        100_000, 100_000, 40 * 100_000, dtype=np.float32, seed=2), np),
        "hybrid(8w+8d)", "df16", ("sell_row_df", "sell_slot_df")),
    # the CSR5 path: Method.CSR5 asked for, or AUTO resolving to it
    "clustered200k_csr5": (_clustered200k, "coo2", None,
                           ("coo2_pass1", "sell_row_bin")),
    "clustered200k_w4096": (lambda g, np: _clustered200k(g, np, 4096),
                            "coo2", None, ("coo2_pass1", "sell_row_bin")),
    "clustered200k_f64_csr5": (lambda g, np: _to_f64(_clustered200k(g, np),
                                                     np),
                               "sell8d", "df16", ("sell_slot_df",)),
    # the large-n path (n > 2M): column stripes, and one windowed stream
    "clustered2500k_s64": (lambda g, np: _clustered2500k(g, np),
                           "sell8d-striped[2]", "bf16", ("sell_slot",)),
    "clustered2500k_s64_f64": (lambda g, np: _to_f64(_clustered2500k(g, np),
                                                     np),
                               "sell8d-striped[2]", "df16",
                               ("sell_slot_df",)),
    "uniform250k_4m_d64": (lambda g, np: g.random_uniform(
        250_000, 4_000_000, 64, dtype=np.float32, seed=42),
        "sell8d-striped[3]", "bf16", ("sell_slot",)),
    "tridiag2500k_sell": (lambda g, np: g.banded(2_500_000, 2_500_000, 1,
                                                 dtype=np.float32, seed=7),
                          "sell8d", "palette", ("sell_slot_w",)),
    # the plain run: the plans the JAX package runs through XLA, plain
    # PyTorch here as well (the scans, Balanced2's mega-row split, the
    # chunked SELL, BCSR's block products), and a reorder that gives the
    # DIA kernel back a band
    "powerlaw100k_balanced": (_powerlaw100k, "scan", None, ()),
    "powerlaw100k_balanced_yid": (_powerlaw100k, "scan", None, ()),
    "powerlaw100k_balanced2": (_powerlaw100k, "balanced2", None, ()),
    "powerlaw100k_f64_balanced2": (lambda g, np: _to_f64(_powerlaw100k(
        g, np), np), "balanced2", None, ()),
    "uniform100k_chunked": (lambda g, np: g.random_uniform(
        100_000, 100_000, 40, dtype=np.float32, seed=42), "chunked-sell",
        None, ()),
    "block512_bcsr": (lambda g, np: g.block_random(
        512, 512, blocks_per_row=4, fill=0.4, dtype=np.float32, seed=2),
        "bcsr", None, ()),
    "banded200k_rcm": (_scrambled_band, "dia", None, ("dia",)),
}
#: the CSR5 path's families → the method create_handle is asked for
CSR5_FAMILIES = {"clustered200k_csr5": "CSR5", "clustered200k_w4096": "AUTO",
                 "clustered200k_f64_csr5": "CSR5"}
#: the large-n path's families → (the method asked for, the plan's nw)
LARGE_N_FAMILIES = {"clustered2500k_s64": ("AUTO", 8),
                    "clustered2500k_s64_f64": ("AUTO", 4),
                    "uniform250k_4m_d64": ("AUTO", 8),
                    "tridiag2500k_sell": ("SELL_C_SIGMA", 1)}
#: the plain run's families → (the method asked for, VectorizedWay, the
#: reorder, the method it must resolve to: Balanced2 must not demote)
PLAIN_FAMILIES = {
    "powerlaw100k_balanced": ("BALANCED", "VPU", None, "BALANCED"),
    "powerlaw100k_balanced_yid": ("BALANCED_YID", "VPU", None,
                                  "BALANCED_YID"),
    "powerlaw100k_balanced2": ("BALANCED2", "VPU", None, "BALANCED2"),
    "powerlaw100k_f64_balanced2": ("BALANCED2", "VPU", None, "BALANCED2"),
    "uniform100k_chunked": ("SELL_C_SIGMA", "NONE", None, "SELL_C_SIGMA"),
    "block512_bcsr": ("AUTO", "VPU", None, "BCSR"),
    "banded200k_rcm": ("AUTO", "VPU", "rcm", "DIA"),
}
#: the plan kinds whose f32 sums are prefix sums
SCAN_KINDS = ("scan", "balanced2")
#: the bf16 phase: family → (the main path's f32 family rounded to bf16,
#: the method AUTO must resolve to and the plan it must build, the kernels
#: it must launch); None: any of BF16_KINDS (the route is logged)
BF16_FAMILIES = {
    "banded4m_bf16": ("banded4m", "DIA", "dia", ("dia",)),
    "clustered200k_bf16": ("clustered200k", "SELL_C_SIGMA", "chunked-sell",
                           ()),
    "uniform100k_bf16": ("uniform100k", "SELL_C_SIGMA", "chunked-sell", ()),
    "powerlaw100k_bf16": ("powerlaw100k", "SELL_C_SIGMA", "scan", ()),
    "webbase1m_bf16": ("webbase1m", None, None, ()),
    "block512_bcsr_bf16": ("block512_bcsr", "BCSR", "bcsr", ()),
}
#: the bf16 phase's mesh family: (name, the matrix, shards, the kind)
BF16_DIST = ("powerlaw100k_bf16_dist4", "powerlaw100k", 4, "scan")
#: the plans the JAX planner gives a bf16 matrix (its SELL and COO2 tile
#: routes take f32 and f64 only)
BF16_KINDS = ("dia", "chunked-sell", "scan", "balanced2", "bcsr", "serial")
#: the striped families whose windowed forms the windowed phase runs, and
#: those it also packs as a sell8w_v2w row stream
WINDOWED_FORMS = ("clustered2500k_s64", "clustered2500k_s64_f64",
                  "uniform250k_4m_d64")
ROW_FORMS = ("clustered2500k_s64", "clustered2500k_s64_f64")


def _clustered2500k(g, np):
    """clustered at 2.5M rows and columns, 8 a row within ±64 columns."""
    return g.clustered(2_500_000, 2_500_000, 8, spread=64,
                       dtype=np.float32, seed=9)


#: the dist path's families → (the matrix: a FAMILIES name or webbase1m,
#: the mesh width, the builder: "auto" for build_dist_auto or "8w:<x mode>"
#: for build_dist_sell8w_plan, the plan kind and x mode it must give, the
#: kernels its shards must launch)
DIST_FAMILIES = {
    "webbase1m_dist1": ("webbase1m", 1, "auto", "graph",
                        "replicated/replicated", ("sell_v1", "sell_slot")),
    "webbase1m_dist4": ("webbase1m", 4, "auto", "graph",
                        "replicated/replicated", ("sell_v1", "sell_slot")),
    "powerlaw100k_dist1": ("powerlaw100k", 1, "auto", "hybrid",
                           "replicated/replicated",
                           ("sell_v1", "sell_slot")),
    "powerlaw100k_f64_dist1": ("powerlaw100k_f64", 1, "auto", "hybrid",
                               "replicated/replicated",
                               ("sell_v1_df", "sell_slot_df")),
    "clustered200k_8w_dist4": ("clustered200k", 4, "8w:allgather", "sell8w",
                               "allgather", ("sell_v1",)),
    "clustered200k_f64_8w_dist4": ("clustered200k_f64", 4, "8w:halo",
                                   "sell8w", "halo", ("sell_v1_df",)),
    "clustered200k_dist4": ("clustered200k", 4, "auto", "sell8d", "halo",
                            ("sell_slot",)),
    "banded1m_f64_dist4": ("banded1m_f64", 4, "auto", "dia", "halo", ()),
    "powerlaw100k_dist4": ("powerlaw100k", 4, "auto", "scan", "replicated",
                           ()),
    "uniform250k_4m_d64_dist4": ("uniform250k_4m_d64", 4, "auto",
                                 "sell8d_cols", "col-shards",
                                 ("sell_slot",)),
}


#: the multihost phase: the four-shard mesh families, each run by two
#: rank processes of two shards each on ``cuda:0`` over gloo
MULTIHOST_FAMILIES = ("webbase1m_dist4", "clustered200k_8w_dist4",
                      "clustered200k_f64_8w_dist4", "clustered200k_dist4",
                      "banded1m_f64_dist4", "powerlaw100k_dist4",
                      "uniform250k_4m_d64_dist4")
#: a rank process's time limit, seconds
RANK_TIMEOUT = 420


def method_of(name):
    """The method create_handle is asked for."""
    if name in PLAIN_FAMILIES:
        return PLAIN_FAMILIES[name][0]
    if name in LARGE_N_FAMILIES:
        return LARGE_N_FAMILIES[name][0]
    return CSR5_FAMILIES.get(name, "AUTO")


def path_of(name):
    """The counted run a family belongs to: plain, large_n, csr5, f64 or
    f32."""
    if name in PLAIN_FAMILIES:
        return "plain"
    if name in LARGE_N_FAMILIES:
        return "large_n"
    if name in CSR5_FAMILIES:
        return "csr5"
    return "f64" if name.endswith("_f64") else "f32"


KERNELS = {
    "sell_row": ("spmv_tpu_torch/csrc/sell.cu",
                 "spmv_tpu/ops/pallas_sell.py:202"),
    "sell_slot": ("spmv_tpu_torch/csrc/sell.cu",
                  "spmv_tpu/ops/pallas_sell.py:202"),
    "dia": ("spmv_tpu_torch/csrc/dia.cu", "spmv_tpu/ops/pallas_dia.py:43"),
    "sell_row_df": ("spmv_tpu_torch/csrc/sell.cu",
                    "spmv_tpu/ops/pallas_sell.py:815"),
    "sell_slot_df": ("spmv_tpu_torch/csrc/sell.cu",
                     "spmv_tpu/ops/pallas_sell.py:815"),
    "dia_f64": ("spmv_tpu_torch/csrc/dia.cu",
                "spmv_tpu/ops/pallas_dia.py:108"),
    "coo2_pass1": ("spmv_tpu_torch/csrc/coo2.cu",
                   "spmv_tpu/ops/pallas_coo2.py:29"),
    "sell_row_bin": ("spmv_tpu_torch/csrc/sell.cu",
                     "spmv_tpu/ops/pallas_sell.py:339"),
    "sell_row_w": ("spmv_tpu_torch/csrc/sell.cu",
                   "spmv_tpu/ops/pallas_sell.py:339"),
    "sell_slot_w": ("spmv_tpu_torch/csrc/sell.cu",
                    "spmv_tpu/ops/pallas_sell.py:430"),
    "sell_row_df_w": ("spmv_tpu_torch/csrc/sell.cu",
                      "spmv_tpu/ops/pallas_sell.py:538"),
    "sell_slot_df_w": ("spmv_tpu_torch/csrc/sell.cu",
                       "spmv_tpu/ops/pallas_sell.py:538"),
    "sell_v1": ("spmv_tpu_torch/csrc/sell.cu",
                "spmv_tpu/ops/pallas_sell.py:57"),
    "sell_v1_df": ("spmv_tpu_torch/csrc/sell.cu",
                   "spmv_tpu/ops/pallas_sell.py:132"),
    "sell_v1_bin": ("spmv_tpu_torch/csrc/sell.cu",
                    "spmv_tpu/ops/pallas_sell.py:77"),
    # no TPU kernel: the hybrid's light rows, where the TPU ran K1 slot
    "sell_cs": ("spmv_tpu_torch/csrc/sell_cs.cu", "none"),
    # no TPU kernel: the hybrid's heavy rows, where the TPU ran K1 row
    "csr_split": ("spmv_tpu_torch/csrc/csr_split.cu", "none"),
    # the planner's calibration probes (P1-P9 of baselines/)
    "tile_stream": ("spmv_tpu_torch/csrc/probes.cu",
                    "baselines/probe2_stream.py:55"),
    "tile_body": ("spmv_tpu_torch/csrc/probes.cu",
                  "baselines/probe3_v2proto.py:151"),
    "window_gather": ("spmv_tpu_torch/csrc/probes.cu",
                      "baselines/probe_wide_gather_r5.py:88"),
    "tiny": ("spmv_tpu_torch/csrc/probes.cu", "baselines/probe5_floor.py:69"),
    "fma_err": ("spmv_tpu_torch/csrc/probes.cu",
                "baselines/probe_r4_compute.py:60"),
}
#: the probe kernels that replace more than one Pallas probe: the others
ALSO_REPLACES = {
    "tile_stream": ("baselines/probe3_v2proto.py:56",
                    "baselines/probe_step_overhead.py:54"),
    "tile_body": ("baselines/probe2_stream.py:107",
                  "baselines/probe4_body.py:94"),
}


def log(msg):
    print(msg, flush=True)


def log_matrix(name, a):
    """Log a generated family's identity: its shape and a sha256 of its
    (rowptr, colidx, vals) bytes as stored, in that order (the generator
    draws from numpy, whose version the toolchain line logs)."""
    import hashlib
    h = hashlib.sha256()
    for arr in (a.rowptr, a.colidx, a.vals):
        h.update(arr.tobytes())
    log(json.dumps({"phase": "matrix", "family": name, "m": a.m, "n": a.n,
                    "nnz": int(a.nnz), "dtype": str(a.vals.dtype),
                    "sha256": h.hexdigest()}))


def _cmd_line(cmd):
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    out = (res.stdout or res.stderr).strip().splitlines()
    return out[-1] if out else f"exit {res.returncode}"


def read_counts():
    """Every kernel's launch count: a copy of ``profiling.launches``, 0 for
    a kernel of :data:`KERNELS` that did not launch."""
    from spmv_tpu_torch.utils.profiling import launches
    return {**dict.fromkeys(KERNELS, 0), **launches}


def zero_counts():
    from spmv_tpu_torch.utils.profiling import launches
    launches.clear()


def cuda_ms(fn, x, iters=ITERS, cold=False):
    """Median CUDA-event time of fn(x) in ms, after warm-up; ``cold``
    rewrites the L2 flush buffer before each call, outside the events."""
    import torch
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cold:
            flush_l2()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(x)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


_flush = {}


def flush_l2():
    """The cold-L2 flush before a timed call: ``probes.flush_l2``, which
    rewrites 256 MB of scratch in place so the next call finds nothing of
    its inputs in the 50 MB L2.  The first call also records the flush's
    kernel names, which the profile windows leave out of device times
    (its scratch is allocated before, outside the profile)."""
    import torch
    from spmv_tpu_torch.bench.probes import flush_l2 as rewrite_scratch
    dev = torch.device("cuda", torch.cuda.current_device())
    if "keys" not in _flush:
        from torch.profiler import ProfilerActivity, profile
        rewrite_scratch(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rewrite_scratch(dev)
            torch.cuda.synchronize()
        _flush["keys"] = {ev.key for ev in prof.key_averages()}
    rewrite_scratch(dev)


def scaled_err(y, ref, absref, bound, atol=0.0):
    """max_i |y_i - ref_i| / ((|A||x|)_i + atol / bound), max |y_i -
    ref_i|, and whether all are within ``bound`` · (|A||x|)_i + ``atol``."""
    import torch
    d = (y.double() - ref.double()).abs()
    den = absref.double() + atol / bound
    ok = bool((d <= bound * den + 1e-300).all())
    ratio = torch.where(den > 0, d / den.clamp_min(1e-300),
                        torch.where(d > 0, float("inf"), 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0, \
        float(d.max()) if d.numel() else 0.0, ok


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (to time the same
    plan without the kernels): the stream kinds of ``ops.KINDS``, which a
    plan bound inside the block calls, and the wrappers that the COO2 and
    striped plans call by name.  Yields ``bind(h)``: ``h``'s plan bound
    inside the block, x and y permuted as ``h`` permutes them."""
    import numpy as np
    import torch
    from spmv_tpu_torch import handle as th, ops
    from spmv_tpu_torch.ops import coo2, csr_split, dia, sell, sell_cs
    plain = {sell.sell_spmv: sell.sell_plain, dia.dia_spmv: dia.dia_plain,
             sell_cs.cs_spmv: sell_cs.cs_plain,
             csr_split.split_spmv: csr_split.split_plain}
    saved = (dict(ops.KINDS), sell.sell_spmv, coo2.coo2_pass1)
    for k, kind in saved[0].items():
        ops.KINDS[k] = dataclasses.replace(
            kind, product=plain.get(kind.product, kind.product))
    sell.sell_spmv = sell.sell_plain
    coo2.coo2_pass1 = coo2.coo2_pass1_plain

    def bind(h):
        f = th._make_bound(h.method, h.plan, h.m)
        if h.perm is None:
            return f
        perm = torch.as_tensor(np.asarray(h.perm), dtype=torch.int64,
                               device=h.device)
        inv = torch.argsort(perm)
        return lambda x: f(x[perm])[inv]
    try:
        yield bind
    finally:
        ops.KINDS.update(saved[0])
        sell.sell_spmv, coo2.coo2_pass1 = saved[1:]


def is_dia(st):
    return hasattr(st, "offsets")


def is_coo2(st):
    """A COO2 plan's pass 1 (its pass 2 is a binary SELL stream)."""
    return hasattr(st, "window_ids")


def is_cs(st):
    """A SELL-32-σ stream with explicit columns (K12)."""
    return hasattr(st, "slice_ptr")


def is_split(st):
    """A row-split CSR stream with explicit columns (K13)."""
    return hasattr(st, "piece_ptr")


def kernel_of(st):
    """The kernel name that runs a placed stream."""
    import torch
    from spmv_tpu_torch.ops import sell
    if is_dia(st):
        return "dia_f64" if st.data.dtype == torch.float64 else "dia"
    if is_coo2(st):
        return "coo2_pass1"
    if is_cs(st):
        return "sell_cs"
    if is_split(st):
        return "csr_split"
    return sell.kernel_name(st)


def abs_stream(st):
    if is_dia(st):
        return dataclasses.replace(st, data=st.data.abs())
    if is_coo2(st) or is_cs(st) or is_split(st):
        return dataclasses.replace(st, vals=st.vals.abs())
    return dataclasses.replace(
        st, palette=st.palette.abs(),
        vals=None if st.vals is None else st.vals.abs(),
        vals_lo=None if st.vals_lo is None else st.vals_lo.abs())


def stream_bound(st, nnz):
    """(bound_ms, bound_by, bytes, stream_bound_ms, stream_bytes).

    ``bound_ms`` is the SpMV's own bound over the stream's ``nnz`` nonzero
    values (an explicitly stored zero needs no work): each read once in the
    stream's own encoding without its padding (SELL: a slot's meta and values, the palette once; DIA: the
    values, the columns following from the offsets), x read once and y
    written once at its real rows, against 2 operations a nonzero.
    ``stream_bound_ms`` is the bound of the packed stream as it is stored:
    every slot with its padding, the chunk tables and the kernel's
    block-padded output."""
    dtype = "float32" if is_coo2(st) else str(st.dtype).replace("torch.",
                                                                 "")
    esize = 8 if dtype == "float64" else 4
    xy = (st.n + st.m) * esize
    ops = 2 * nnz

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    if is_dia(st):
        nbytes = nnz * st.data.element_size() + nb(st.offsets_dev) + xy
        stored = nb(st.data, st.offsets_dev) + xy
    elif is_coo2(st):
        # a nonzero's meta and value in, its product out; x once
        slot = nb(st.meta, st.vals) / st.meta.numel() + 4
        nbytes = nnz * slot + nb(st.window_ids) + st.n * 4
        stored = nb(st.meta, st.vals, st.window_ids) + (
            st.n + st.meta.numel()) * 4
        ops = nnz
    elif is_cs(st):
        # a nonzero's column and value; the layout as stored adds its
        # padding slots, each lane's output row and the slice offsets
        nbytes = nnz * 8 + xy
        stored = nb(st.cols, st.vals, st.rows, st.slice_ptr) + xy
    elif is_split(st):
        # a nonzero's column and value; as stored, the piece and row tables
        nbytes = nnz * 8 + xy
        stored = nb(st.cols, st.vals, st.piece_ptr, st.piece_row,
                    st.row_piece) + xy
    else:
        slot = nb(st.meta, st.vals, st.vals_lo) / st.meta.numel()
        binary = st.value_mode == "binary"   # no palette, one add a slot
        nbytes = nnz * slot + (0 if binary else nb(st.palette)) + xy
        stored = (nb(st.meta, st.vals, st.vals_lo, st.tinfo, st.gpk,
                     st.chunk_step_ptr, st.chunk_block, st.block_chunk_ptr)
                  + (0 if binary else nb(st.palette))
                  + (st.n + st.nblocks * 1024) * esize)
        ops = nnz if binary else ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, stored / HBM_BYTES_PER_S * 1e3,
            stored)


def pass1_columns(p):
    """The (ntiles, 8, 128) column every slot of a COO2 pass 1 reads."""
    import torch
    meta = p.meta.to(torch.int64) & 0xFFFF
    r = meta & 127
    s = (torch.gather(meta, 2, r) >> 7) & 7
    return p.window_ids.to(torch.int64)[:, None, None] * 1024 + s * 128 + r


def pass1_nonzeros(p):
    """(mask, columns, values) of a COO2 pass 1's nonzero slots: the
    (ntiles, 8, 128) mask, the columns and values in slot order."""
    import torch
    col = pass1_columns(p)
    vals = p.vals.to(torch.float32)
    keep = (vals != 0) & (col < p.n)
    return keep, col[keep], vals[keep]


def stream_csr(st):
    """The stream's own matrix as a CUDA sparse CSR tensor (its stored
    nonzeros), for the cuSPARSE yardstick."""
    import torch
    from spmv_tpu_torch.ops import sell
    if is_dia(st):
        i = torch.arange(st.m, device=st.data.device)
        rows, cols, vals = [], [], []
        for d, o in enumerate(st.offsets):
            v = st.data[d].to(st.dtype)
            keep = (i + o >= 0) & (i + o < st.n) & (v != 0)
            rows.append(i[keep])
            cols.append(i[keep] + o)
            vals.append(v[keep])
        rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
        shape = (st.m, st.n)
    elif is_cs(st):
        from spmv_tpu_torch.ops import sell_cs
        rows, cols, vals = sell_cs.cs_decode(st)
        shape = (st.m, st.n)
    elif is_split(st):
        from spmv_tpu_torch.ops import csr_split
        rows, cols, vals = csr_split.split_decode(st)
        shape = (st.m, st.n)
    else:
        rows, cols, vals = [], [], []
        for t0 in range(0, st.meta.shape[0], sell.PLAIN_TILES):
            r, c, v = sell.sell_decode(st, t0, t0 + sell.PLAIN_TILES)
            keep = (v != 0) & (c < st.n)
            rows.append(r[keep])
            cols.append(c[keep])
            vals.append(v[keep])
            del r, c, v, keep
        rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
        shape = (st.nblocks * 1024, st.n)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def matrix_csr(a, dev):
    import numpy as np
    import torch
    dt = torch.float64 if a.vals.dtype == np.float64 else torch.float32
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.rowptr.astype(np.int64)),
        torch.from_numpy(a.colidx.astype(np.int64)),
        torch.from_numpy(a.vals).to(dt), size=(a.m, a.n)).to(dev)


def check_stream(st, x, timing=False):
    """Kernel vs plain version on one stream; returns a record."""
    import torch
    from spmv_tpu_torch.ops import coo2, csr_split, dia, sell, sell_cs
    if is_dia(st):
        run, plain = dia.dia_spmv, dia.dia_plain
    elif is_coo2(st):
        run, plain = coo2.coo2_pass1, coo2.coo2_pass1_plain
    elif is_cs(st):
        run, plain = sell_cs.cs_spmv, sell_cs.cs_plain
    elif is_split(st):
        run, plain = csr_split.split_spmv, csr_split.split_plain
    else:
        run, plain = sell.sell_spmv, sell.sell_plain
    absref = plain(abs_stream(st), x.abs())
    y = run(st, x)
    ref = plain(st, x)
    torch.cuda.synchronize()
    kern = kernel_of(st)
    bound = BOUND_F64_KERNEL if x.dtype == torch.float64 else BOUND
    rel, mabs, ok = scaled_err(y, ref, absref, bound)
    diff = None
    if is_coo2(st):
        # one f32 product a slot, rounded as the plain version rounds it
        diff = int(bit_diff(y, ref))
        ok = diff == 0
    if not ok:
        # what state a wrong launch leaves, and whether it repeats
        sets = getattr(st, "tickets_by_stream", None)
        left = (None if sets is None else
                sum(int(t.count_nonzero()) for t in sets.values()))
        again = scaled_err(run(st, x), ref, absref, bound)[0]
        # a replace copy starts with no tickets: zeros on its first launch
        fresh = st if sets is None else dataclasses.replace(st)
        fresh_err = scaled_err(run(fresh, x), ref, absref, bound)[0]
        raise AssertionError(
            f"{kern}: kernel disagrees with its plain version (max scaled "
            f"error {rel:.3g}; tickets left nonzero {left}; again "
            f"{again:.3g}; with zeroed tickets {fresh_err:.3g}; chunks "
            f"{getattr(st, 'nchunks', None)}; positions differing in bits "
            f"{diff})")
    rec = {"max_scaled_err": rel, "max_abs_err": mabs}
    if diff is not None:
        rec["bit_diff"] = diff
    if timing:
        fn = lambda v: run(st, v)  # noqa: E731
        rec["ms"] = cuda_ms(fn, x)
        rec["cold_ms"] = cuda_ms(fn, x, cold=True)
        prof = profile_calls(fn, x)
        cold = profile_calls(fn, x, cold=True)
        rec.update(device_ms=prof["device_ms"],
                   device_ms_spread=prof.get("device_ms_spread"),
                   cold_device_ms=cold["device_ms"],
                   cold_device_ms_spread=cold.get("device_ms_spread"))
        rec["plain_ms"] = cuda_ms(lambda v: plain(st, v), x)
        if is_coo2(st):
            # pass 1 alone is a gather and a multiply: two PyTorch calls
            keep, cols, vals = pass1_nonzeros(st)
            rec["library_call"] = "x.take(cols) * vals"
            rec["library_ms"] = cuda_ms(lambda v: v.take(cols) * vals, x)
            rec["library_max_abs_err"] = float(
                (x.take(cols) * vals - y.reshape(keep.shape)[keep])
                .abs().max())
            nnz = vals.numel()
            del keep, cols, vals
        else:
            csr = stream_csr(st)
            y_lib = csr @ x
            rec["library_call"] = "cuSPARSE CSR @ x"
            rec["library_ms"] = cuda_ms(lambda v: csr @ v, x)
            rec["library_scaled_err"] = scaled_err(
                y_lib[:ref.numel()], ref, absref, bound)[0]
            nnz = csr.values().numel()
            del csr
        (rec["bound_ms"], rec["bound_by"], rec["bytes"],
         rec["stream_bound_ms"], rec["stream_bytes"]) = stream_bound(st, nnz)
    return rec


def kernel_phase(dev, kern):
    """Coverage: every value mode, bundle width and cell_w setting, f32
    and f64, the two COO2 kernels, and the v1 kernels (timed on their
    full-size packs into ``kern``)."""
    import numpy as np
    import torch
    from spmv_tpu_torch.formats import coo2 as coo2_fmt, dia as dia_fmt
    from spmv_tpu_torch.formats.sell8d import pack_sell8d
    from spmv_tpu_torch.formats.sell8w import pack_sell8w, plan_v2
    from spmv_tpu_torch.bench import timing
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.ops import coo2, dia, sell
    from spmv_tpu_torch.types import CsrMatrix

    rng = np.random.default_rng(0)

    def revalue(a, mode, entries):
        if mode in ("palette", "palette_df"):
            uniq = (np.arange(1, entries) / 8.0 if mode == "palette"
                    else rng.standard_normal(entries - 1))
            v = uniq[rng.integers(0, entries - 1, a.nnz)]
        elif mode == "bf16":
            v = rng.integers(1, 256, a.nnz) / 32.0
        else:
            v = rng.standard_normal(a.nnz)
        dt = np.float64 if mode in sell.DF_MODES else np.float32
        return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, v.astype(dt))

    def row_plan(a, mode):
        hi = pack_sell8w(a)
        if mode not in sell.DF_MODES:
            return plan_v2(hi)
        lo = pack_sell8w(CsrMatrix(
            a.m, a.n, a.rowptr, a.colidx,
            (a.vals - a.vals.astype(np.float32)).astype(np.float32)))
        return plan_v2(hi, lo_tiles=lo.vals, force_value_mode=mode)

    def xvec(n, dt):
        return torch.from_numpy(rng.standard_normal(n).astype(dt)).to(dev)

    rows = []
    # resident (n ≤ 2M: K1, K2) and windowed (n = 2.5M: K5 values, K6,
    # K7) streams of every value mode, bundle width and cell_w setting
    grids = (
        (generate.clustered(50_000, 50_000, 24, spread=400,
                            dtype=np.float32, seed=1),
         generate.random_uniform(30_000, 300_000, 10, dtype=np.float32,
                                 seed=2)),
        (generate.clustered(30_000, 2_500_000, 24, spread=400,
                            dtype=np.float32, seed=1),
         generate.clustered(30_000, 2_500_000, 10, spread=20_000,
                            dtype=np.float32, seed=2)))
    for base, scat in grids:
        for modes, dt in ((("f32", "bf16", "palette"), np.float32),
                          (sell.DF_MODES, np.float64)):
            for mode in modes:
                v2 = row_plan(revalue(base, mode, 64), mode)
                assert v2.value_mode == mode, (mode, v2.value_mode)
                st = sell.prepare_sell(v2, dev, slot_mode=False)
                rec = check_stream(st, xvec(base.n, dt))
                rows.append({"kernel": kernel_of(st), "n": base.n,
                             "value_mode": mode, **rec})
            for nw in (1, 2, 4, 8):
                for cell_w in ((False,) if nw == 1 else (False, True)):
                    for mode in modes:
                        a = revalue(scat, mode, 64 >> (nw.bit_length() - 1))
                        pk, _ = pack_sell8d(a, g="auto",
                                            max_pad_ratio=256.0,
                                            max_spill=0.05, nw=nw,
                                            cell_w=cell_w,
                                            force_value_mode=mode)
                        st = sell.prepare_sell(pk, dev, slot_mode=True)
                        rec = check_stream(st, xvec(a.n, dt))
                        if (mode, nw, cell_w) == ("f32", 2, True) \
                                and a.n <= sell.V2_MAX_N:
                            slot_f32 = st
                        rows.append({"kernel": kernel_of(st), "n": a.n,
                                     "nw": nw, "cell_w": cell_w,
                                     "value_mode": mode, **rec})
    band = generate.banded(1_000_000, 1_000_200, 6, dtype=np.float32,
                           seed=3, exact=False)
    for mode in ("f32", "bf16", "f64"):
        a = band if mode != "f64" else _to_f64(band, np)
        d = dia_fmt.pack_dia(a, compress="bf16" if mode == "bf16"
                             else "none")
        p = dia.prepare_dia(d, dev)
        rec = check_stream(p, xvec(band.n, np.float64 if mode == "f64"
                                   else np.float32))
        rows.append({"kernel": kernel_of(p), "value_mode": mode, **rec})
    # COO2: pass 1 over f32 (gaussian) and bf16 (k/8) values, bit for bit,
    # at n ≡ 0 (mod 4) and at n ≡ 1, 2, 3, whose last window ends in
    # columns the kernel does not stage (its bulk copies move whole 16-B
    # words); and the binary reduce over R, whose n (the product
    # positions) passes 2M here
    for tail in (0, 1, 2, 3):
        for exact in (False, True):
            a = generate.clustered(100_000, 100_000 + tail, 24,
                                   spread=2048, dtype=np.float32, seed=1,
                                   exact=exact)
            c = coo2.prepare_coo2(coo2_fmt.pack_coo2(a, max_pad2=8.0), dev)
            x = xvec(a.n, np.float32)
            rec = check_stream(c, x)
            rows.append({"kernel": "coo2_pass1", "n": c.n, "value_mode":
                         str(c.vals.dtype).replace("torch.", ""),
                         "tiles": c.ntiles, "chunks": c.chunk_ptr.numel() - 1,
                         **rec})
            if tail:
                rec, x = coo2_nonfinite(c, x)
                rows.append(rec)
                if not exact and tail == 3:
                    rows.append(coo2_stress(c, x))
            elif exact:
                assert c.reduce.n > 2_000_000, c.reduce.n
                prod = coo2.coo2_pass1_plain(c, x)[:c.reduce.n]
                rec = check_stream(c.reduce, prod)
                coo2_r = (c.reduce, prod)
                rows.append({"kernel": kernel_of(c.reduce), "n": c.reduce.n,
                             "tiles": c.reduce.meta.shape[0], **rec})
    # the v1 kernels on full-size v1 packs, as build_sell8w_fn places them
    def v1(p, binary=False, lo=None):
        return sell.prepare_v1(p.window_ids, sell.pack_gpk(p.slice_ids),
                               sell.binary_meta_v1(p) if binary else p.meta,
                               None if binary else p.vals, p.nslices, p.m,
                               p.n, dev, vals_lo=lo)

    c200 = _clustered200k(generate, np)
    c64 = _to_f64(c200, np)
    hi = c64.vals.astype(np.float32)
    lo = pack_sell8w(CsrMatrix(c64.m, c64.n, c64.rowptr, c64.colidx,
                               (c64.vals - hi.astype(np.float64))
                               .astype(np.float32))).vals
    pk = pack_sell8w(c200)
    for st, dt in ((v1(pk), np.float32), (v1(pk, binary=True), np.float32),
                   (v1(pack_sell8w(CsrMatrix(c64.m, c64.n, c64.rowptr,
                                             c64.colidx, hi)), lo=lo),
                    np.float64)):
        rec = check_stream(st, xvec(st.n, dt), timing=True)
        rec["host_us"] = timing.host_us(lambda v: sell.sell_spmv(st, v),
                                        xvec(st.n, dt))
        keep_kernel(kern, kernel_of(st), rec, st, "clustered200k (v1 pack)")
        rows.append({"kernel": kernel_of(st), "n": st.n,
                     "tiles": st.meta.shape[0], **rec})
    rows += nonfinite_checks(dev, slot_f32, pk, v1, coo2_r, rng)
    del pk, lo, c64
    wide = pack_sell8w(grids[1][0])
    st = v1(wide)
    assert st.n > 2_000_000
    rows.append({"kernel": kernel_of(st), "n": st.n,
                 "tiles": st.meta.shape[0],
                 **check_stream(st, xvec(st.n, np.float32))})
    for r in rows:
        log(json.dumps({"phase": "kernels", **r}))
    return rows


#: calls on one x whose ys must agree bit for bit in the sell_cs phase
CS_REPEAT_CALLS = 20


def _cs_matrices(dev):
    """The sell_cs phase's matrices: (name, a maker, whether to time)."""
    import numpy as np
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.types import CsrMatrix

    def powerlaw():
        a = generate.power_law(20_000, 20_000, 800_000, dtype=np.float32,
                               seed=2)
        v = np.random.default_rng(0).standard_normal(a.nnz)
        return CsrMatrix(a.m, a.n, a.rowptr, a.colidx, v.astype(np.float32))

    def graph():
        # the graph500-s19 cell's matrix, drawn on the card from seed 1
        from spmvbench.generators import kronecker
        with open(os.path.join(ROOT, "spmvbench", "configs",
                               "graph500-s19.json")) as f:
            cfg = json.load(f)
        g = kronecker.generate(cfg, 1, dev)
        return CsrMatrix(g["m"], g["n"], g["rowptr"], g["colidx"], g["vals"])

    return (("powerlaw20k_gauss", powerlaw, False),
            ("graph500-s19", graph, True))


def sell_cs_phase(dev, kern):
    """Phases 3a and 3b (see the module): K12 and K13 on their two
    handles; their numbers go into ``kern``.  Returns the launch counts of
    its counted products."""
    import numpy as np
    import torch
    import spmv_tpu_torch as st
    from spmv_tpu_torch import handle as th
    from spmv_tpu_torch.ops import sell_cs

    launches = {k: 0 for k in KERNELS}
    rng = np.random.default_rng(0)
    for name, make, timing in _cs_matrices(dev):
        a = make()
        log_matrix(name, a)
        t0 = time.perf_counter()
        h = st.create_handle(a, device=dev)
        predeal_s = time.perf_counter() - t0
        kind = th.plan_kind(h.plan)
        if kind != "hybrid(split+cs)":
            raise AssertionError(f"{name}: AUTO planned {kind} "
                                 f"({h.plan.get('value_mode')}) on the card, "
                                 "not hybrid(split+cs)")
        stream = h.plan["hybrid"][1]["sell_cs"]
        x = torch.from_numpy(rng.standard_normal(a.n).astype(np.float32)
                             ).to(dev)
        zero_counts()
        y = st.spmv(h, x)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts["sell_cs"] != 1 or counts["csr_split"] != 1 \
                or counts["sell_row"] or counts["sell_slot"]:
            raise AssertionError(f"{name}: a product launched {counts}")
        for k, c in counts.items():
            launches[k] += c
        xh = x.cpu().numpy().astype(np.float64)
        ref, absref, bound, ref_name = reference(a, xh, np)
        ref, absref = torch.from_numpy(ref), torch.from_numpy(absref)
        rel, mabs, ok = scaled_err(y.cpu(), ref, absref, bound)
        if not ok:
            raise AssertionError(f"{name}: max scaled error {rel:.3g} "
                                 f"against {ref_name}")
        rec = check_stream(stream, x, timing=timing)
        diff = int(bit_diff(sell_cs.cs_spmv(stream, x),
                            sell_cs.cs_plain(stream, x)))
        # padding slots read x[0]: an inf there gives NaN exactly where
        # the plain version has NaN, and the finite rows agree
        xi = x.clone()
        xi[0] = float("inf")
        yk, yp = sell_cs.cs_spmv(stream, xi), sell_cs.cs_plain(stream, xi)
        nan = torch.isnan(yk)
        if not torch.equal(nan, torch.isnan(yp)) or not torch.allclose(
                yk[~nan], yp[~nan], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{name}: with an inf at x[0] K12 and its "
                                 "plain version disagree")
        repeats_its_y(f"{name} sell_cs",
                      lambda v: sell_cs.cs_spmv(stream, v), x,
                      calls=CS_REPEAT_CALLS)
        repeats_its_y(name, h, x, calls=CS_REPEAT_CALLS)
        kern["sell_cs"]["max_abs_err"] = max(kern["sell_cs"]["max_abs_err"],
                                             rec["max_abs_err"])
        slots = stream.vals.numel()
        out = {"phase": "sell_cs", "family": name, "plan": kind, "m": a.m,
               "n": a.n, "nnz": int(a.nnz), "predeal_s": predeal_s,
               "light_nnz": stream.nnz, "slots": slots,
               "slots_a_nonzero": slots / max(stream.nnz, 1),
               "layout_bytes": sum(t.numel() * t.element_size() for t in (
                   stream.cols, stream.vals, stream.rows, stream.slice_ptr)),
               "slices": stream.nslices, "max_len": stream.max_len,
               "max_scaled_err": rel, "max_abs_err_product": mabs,
               "repeats_its_y": CS_REPEAT_CALLS,
               "bit_diff_vs_plain": diff,
               "inf_x0_nan_rows": int(nan.sum()), "kernel": rec}
        against = None
        if timing:
            keep_kernel(kern, "sell_cs", rec, stream, f"{name} light part")
            against = _cs_against_8d(h, a, x, ref, absref, bound)
            out.update(against["record"])
        log(json.dumps(out))
        log(json.dumps(_split_checks(name, h, x, kern, against)))
        del h, stream, against
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _cs_against_8d(h, a, x, ref, absref, bound):
    """The handle ``h`` (K12 light part, K13 heavy part) beside the plan
    the CPU's route gives the same matrix (SELL-8D light part on K1 slot,
    SELL-8W heavy part on K1 row), both on the card: the two light
    streams' bytes and times, the heavy part's bytes, and the two whole
    products' ms in turns (8d, cs, cs, 8d).  Returns {"record": those
    numbers, "heavy_k1": the SELL-8W heavy stream, "prep": the hybrid's
    parts}."""
    import torch
    from spmv_tpu_torch import handle as th
    from spmv_tpu_torch import ops
    from spmv_tpu_torch.formats import sell_cs as cs_fmt
    from spmv_tpu_torch.formats.sell8d import prepare_hybrid

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)

    prep = prepare_hybrid(a)
    plan = th._build_plan(a, h.method, 0, hints={"hybrid_prep": prep})
    if th.plan_kind(plan) != "hybrid(8w+8d)":
        raise AssertionError(f"the CPU's route is {th.plan_kind(plan)}")
    placed = th._place(plan, x.device)
    f8d = th._make_bound(h.method, placed, a.m)
    y8d = f8d(x)
    rel, _, ok = scaled_err(y8d.cpu(), ref, absref, bound)
    if not ok:
        raise AssertionError(f"SELL-8D plan: max scaled error {rel:.3g}")
    slot = placed["hybrid"][1]["sell8d"]
    heavy = placed["hybrid"][0]["sell8w_v2"]
    slot_rec = check_stream(slot, x, timing=True)
    light_nnz = h.plan["hybrid"][1]["sell_cs"].nnz
    turns = {"8d": [], "cs": []}
    for k in ("8d", "cs", "cs", "8d"):
        turns[k].append(cuda_ms(f8d if k == "8d" else h, x))
    record = {
        "rule": {"sell8d_tiles_estimate": prep.ts,
                 "sell8d_bytes_estimate": ops.sell_bytes(prep.ts),
                 "cs_bytes": cs_fmt.layout_bytes(prep.sparse.row_lengths)},
        "sell8d_light": {"tiles": slot.meta.shape[0],
                         "bytes": nb(slot.meta, slot.vals, slot.vals_lo),
                         "slots_a_nonzero": slot.meta.numel() / light_nnz,
                         "nw": slot.nw, "value_mode": slot.value_mode,
                         "rest_nnz": _rest_nnz(placed["hybrid"][1]),
                         "kernel": slot_rec},
        "heavy": {"tiles": heavy.meta.shape[0],
                  "bytes": nb(heavy.meta, heavy.vals, heavy.vals_lo),
                  "nnz": int(prep.dense_sorted.nnz),
                  "slots_a_nonzero": heavy.meta.numel()
                  / max(prep.dense_sorted.nnz, 1),
                  "value_mode": heavy.value_mode},
        "sell8d_scaled_err": rel,
        "product_ms": turns,
        "product_profile": {"cs": profile_calls(h, x),
                            "8d": profile_calls(f8d, x)}}
    return {"record": record, "heavy_k1": heavy, "prep": prep}


#: a second piece length at which K13 is held bit for bit to its plain
#: version on the graph's heavy rows: more rows split, more tickets taken
SPLIT_CHECK_PIECE = 512


def _split_checks(name, h, x, kern, against):
    """Phase 3b on one handle: K13 (the heavy part) against its plain
    version bit for bit and 20 calls bit for bit; with ``against`` (the
    graph) its times beside K1 row on the CPU route's SELL-8W stream of
    the same rows and cuSPARSE, and the same rows packed at
    ``SPLIT_CHECK_PIECE`` bit for bit their plain version.  Returns the
    phase's line."""
    from spmv_tpu_torch import handle as th
    from spmv_tpu_torch.formats import csr_split as split_fmt
    from spmv_tpu_torch.ops import csr_split

    stream = h.plan["hybrid"][0]["csr_split"]
    diff = int(bit_diff(csr_split.split_spmv(stream, x),
                        csr_split.split_plain(stream, x)))
    if diff:
        raise AssertionError(f"{name}: K13 differs from its plain version "
                             f"in {diff} of {stream.m} rows' bits")
    repeats_its_y(f"{name} csr_split",
                  lambda v: csr_split.split_spmv(stream, v), x,
                  calls=CS_REPEAT_CALLS)
    rec = check_stream(stream, x, timing=against is not None)
    kern["csr_split"]["max_abs_err"] = max(kern["csr_split"]["max_abs_err"],
                                           rec["max_abs_err"])
    out = {"phase": "csr_split", "family": name, "describe":
           th.describe(h.plan), "heavy_nnz": stream.nnz,
           "layout_bytes": sum(t.numel() * t.element_size() for t in (
               stream.cols, stream.vals, stream.piece_ptr, stream.piece_row,
               stream.row_piece)),
           "repeats_its_y": CS_REPEAT_CALLS, "bit_diff_vs_plain": diff,
           "kernel": rec}
    if against is None:
        return out
    keep_kernel(kern, "csr_split", rec, stream, f"{name} heavy part")
    k1 = check_stream(against["heavy_k1"], x, timing=True)
    out["k1_row"] = k1
    out["k13_over_k1_row_device"] = rec["device_ms"] / k1["device_ms"] \
        if isinstance(rec["device_ms"], float) \
        and isinstance(k1["device_ms"], float) else "not measured"
    p = split_fmt.pack_csr_split(against["prep"].dense_sorted,
                                 piece=SPLIT_CHECK_PIECE)
    st = csr_split.prepare_split(p, x.device)
    diff = int(bit_diff(csr_split.split_spmv(st, x),
                        csr_split.split_plain(st, x)))
    if diff:
        raise AssertionError(f"{name}: K13 at P {SPLIT_CHECK_PIECE} differs "
                             f"from its plain version in {diff} rows' bits")
    out["second_piece"] = {"piece": SPLIT_CHECK_PIECE,
                           "split_rows": p.split_rows,
                           "bit_diff_vs_plain": diff}
    return out


def bit_diff(y, ref):
    """The count (a tensor on their device) of positions where two f32
    tensors differ in their bits, a NaN matching any NaN."""
    import torch
    nan = torch.isnan(y)
    return ((nan != torch.isnan(ref))
            | (~nan & (y.view(torch.int32) != ref.view(torch.int32)))).sum()


def repeats_its_y(name, fn, x, calls=REPEAT_CALLS):
    """Fail unless ``calls`` calls of fn(x) give the same y bit for bit:
    every sum of the port has a fixed order on the card (the plain plans'
    segment sums and prefix sums, the SELL kernels' chunk order)."""
    import torch
    y = fn(x)
    for i in range(1, calls):
        again = fn(x)
        if not torch.equal(y, again):
            diff = int((y.view(-1) != again.view(-1)).sum())
            raise AssertionError(f"{name}: call {i + 1} of {calls} gave "
                                 f"another y than the first ({diff} of "
                                 f"{y.numel()} positions differ)")
    return True


def stream_xs(x):
    """The two x of the streams check, x and x reversed, taken in turns by
    each CUDA stream's calls: a launch that counts on tickets another
    launch took, and so adds partial sums before they are written, reads
    another x's stale sums and gives another y (with one x for every call,
    stale partials hold the same sums)."""
    return x, x.flip(0)


def two_streams(fn, x, rounds=STREAM_ROUNDS, calls=STREAM_CALLS,
                want=None):
    """Call fn on two CUDA streams at once, with no sync between launches:
    each round the current stream runs a gate (STREAM_GATE L2 flushes)
    that both streams wait on, the host enqueues ``calls`` calls on each,
    alternating streams, call c of stream i on x number (i + c) % 2 of
    :func:`stream_xs`, and then waits for all; every y is held bit for bit
    to ``want`` (the pair of ys of the two x), by default fn's ys on the
    current stream alone.  Returns the counts of rounds and calls that
    gave another y."""
    import torch
    from spmv_tpu_torch.bench.probes import flush_l2
    dev = x.device
    xs = stream_xs(x)
    wants = [fn(v) for v in xs] if want is None else want
    torch.cuda.synchronize(dev)
    main = torch.cuda.current_stream(dev)
    sides = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    wrong_rounds = wrong_calls = 0
    for _ in range(rounds):
        for _g in range(STREAM_GATE):
            flush_l2(dev)
        gate = main.record_event()
        for s in sides:
            s.wait_event(gate)
        ys = []
        for c in range(calls):
            for i, s in enumerate(sides):
                with torch.cuda.stream(s):
                    ys.append(((i + c) % 2, fn(xs[(i + c) % 2])))
        torch.cuda.synchronize(dev)
        bad = sum(not torch.equal(y, wants[i]) for i, y in ys)
        wrong_calls += bad
        wrong_rounds += bad > 0
        del ys
    return {"rounds": rounds, "calls_a_stream": calls,
            "wrong_rounds": wrong_rounds, "wrong_calls": wrong_calls}


def streams_check(name, fn, x):
    """The streams check of one family: :func:`two_streams`, logged as a
    ``{"phase": "streams", ...}`` line; fails on any wrong y."""
    t0 = time.perf_counter()
    rec = two_streams(fn, x)
    log(json.dumps({"phase": "streams", "family": name, **rec,
                    "wall_s": time.perf_counter() - t0}))
    if rec["wrong_calls"]:
        raise AssertionError(f"{name}: {rec['wrong_calls']} calls on two "
                             "CUDA streams gave another y than one stream "
                             f"alone ({rec['wrong_rounds']} of "
                             f"{rec['rounds']} rounds)")


def coo2_nonfinite(c, x):
    """COO2 pass 1 with x inf at a column below n that a padding slot reads
    and at one past the staged 16-B words of the last window that a
    nonzero slot reads: NaN (0 · inf) and inf exactly where the plain
    version has them, every other product bit for bit.  Returns the record
    and that x."""
    import torch
    from spmv_tpu_torch.ops import coo2
    _keep, cols, _vals = pass1_nonzeros(c)
    col = pass1_columns(c)
    pad = col[(c.vals == 0) & (col < c.n)]
    tail = cols[cols >= (c.n & ~3)]
    if not pad.numel() or not tail.numel():
        raise AssertionError(f"coo2 n={c.n}: no padding column below n "
                             f"({pad.numel()}) or no read past the staged "
                             f"words ({tail.numel()})")
    x = x.clone()
    x[int(pad[0])] = float("inf")
    x[int(tail[0])] = float("inf")
    y, ref = coo2.coo2_pass1(c, x), coo2.coo2_pass1_plain(c, x)
    rec = {"check": "inf at a padding column and past the staged words "
                    "(coo2)", "kernel": "coo2_pass1", "n": c.n,
           "columns": [int(pad[0]), int(tail[0])],
           "nan": int(torch.isnan(y).sum()),
           "nan_plain": int(torch.isnan(ref).sum()),
           "inf": int(torch.isinf(y).sum()), "bit_diff": int(bit_diff(y, ref))}
    if rec["bit_diff"] or not rec["nan"] or not rec["inf"]:
        raise AssertionError(f"coo2 non-finite check failed: {rec}")
    return rec, x


def coo2_stress(c, x, launches=1000):
    """``launches`` launches of COO2 pass 1 on one stream, each held to
    the plain version bit for bit (the differing positions summed on the
    card)."""
    import torch
    from spmv_tpu_torch.ops import coo2
    ref = coo2.coo2_pass1_plain(c, x)
    bad = torch.zeros((), dtype=torch.int64, device=x.device)
    for _ in range(launches):
        bad += bit_diff(coo2.coo2_pass1(c, x), ref)
    rec = {"check": "repeated launches (coo2)", "kernel": "coo2_pass1",
           "n": c.n, "launches": launches, "positions_differing": int(bad)}
    if rec["positions_differing"]:
        raise AssertionError(f"coo2 launches differ: {rec}")
    return rec


def nonfinite_checks(dev, slot_st, pk, v1, coo2_r, rng):
    """Non-finite x against each kernel's plain version: an inf at a
    column that padding slots read (a slot stream; a v1 pack with a dist
    pack's padding tiles, window 0 and first = 0 in the last group) gives
    NaN (0 * inf, as on the TPU) exactly where the plain version does; a
    NaN at product positions no valid slot reads leaves a binary stream's
    result finite (its padding slots add nothing)."""
    import numpy as np
    import torch
    from spmv_tpu_torch.ops import sell

    def padding_column(st):
        rows, col, v = sell.sell_decode(st)
        hit = col[(v == 0) & (col < st.n)]
        return int(hit.flatten()[0]) if hit.numel() else None

    def compare(name, st, x):
        y, ref = sell.sell_spmv(st, x).cpu(), sell.sell_plain(st, x).cpu()
        fin = torch.where(torch.isfinite(x), x, 0.0)
        absref = sell.sell_plain(abs_stream(st), fin.abs()).cpu()
        same = (torch.equal(torch.isnan(y), torch.isnan(ref))
                and torch.equal(torch.isinf(y), torch.isinf(ref)))
        ok_fin = torch.isfinite(ref)
        bound = BOUND_F64_KERNEL if st.dtype == torch.float64 else BOUND
        rel, _, ok = scaled_err(y[ok_fin], ref[ok_fin], absref[ok_fin],
                                bound)
        rec = {"check": name, "kernel": kernel_of(st),
               "nan_rows": int(torch.isnan(y).sum()),
               "nan_rows_plain": int(torch.isnan(ref).sum()),
               "inf_rows": int(torch.isinf(y).sum()),
               "same_nonfinite": same, "finite_scaled_err": rel}
        if not (same and ok):
            raise AssertionError(f"{name}: non-finite pattern or finite "
                                 f"rows differ from the plain version: "
                                 f"{rec}")
        return rec

    out = []
    x = torch.from_numpy(rng.standard_normal(slot_st.n)
                         .astype(np.float32)).to(dev)
    c = padding_column(slot_st)
    x[c] = float("inf")
    rec = compare("inf at a padding column (slot)", slot_st, x)
    if rec["nan_rows"] == 0:
        raise AssertionError(f"slot stream: no NaN from 0 * inf: {rec}")
    out.append(rec)
    # the v1 pack with 6 padding tiles, as a dist pack pads its shards
    ngroups = -(-pk.nslices // 8)
    gpk = np.concatenate([sell.pack_gpk(pk.slice_ids),
                          np.full(6, (ngroups - 1) << 4, np.int32)])
    st = sell.prepare_v1(
        np.concatenate([pk.window_ids, np.zeros(6, np.int32)]), gpk,
        np.concatenate([pk.meta, np.zeros((6, 8, 128), np.int16)]),
        np.concatenate([pk.vals, np.zeros((6, 8, 128), np.float32)]),
        pk.nslices, pk.m, pk.n, dev)
    x = torch.from_numpy(rng.standard_normal(st.n).astype(np.float32)
                         ).to(dev)
    x[0] = float("inf")
    rec = compare("inf at x[0] with padding tiles (v1)", st, x)
    if rec["nan_rows"] == 0:
        raise AssertionError(f"v1 padding tiles: no NaN: {rec}")
    out.append(rec)
    # binary streams: NaN where no valid slot reads
    for name, (st, x) in (("v1", (v1(pk, binary=True), None)),
                          ("coo2 R", coo2_r)):
        if x is None:
            x = torch.from_numpy(rng.standard_normal(st.n)
                                 .astype(np.float32)).to(dev)
        x = x.clone()
        _rows, col, v = sell.sell_decode(st)
        read = torch.zeros(st.n, dtype=torch.bool, device=x.device)
        read[col[(v != 0) & (col < st.n)]] = True
        unread = torch.nonzero(~read).flatten()
        x[unread[:: max(len(unread) // 1000, 1)]] = float("nan")
        rec = compare(f"NaN at unread positions (binary {name})", st, x)
        if rec["nan_rows"] or rec["inf_rows"]:
            raise AssertionError(f"binary {name}: not finite: {rec}")
        out.append(rec)
    return out


def is_flush(key):
    """Whether a profiler key is the L2 flush's kernel (or its launch)."""
    return key in _flush.get("keys", ()) or "bitwise_not" in key


def profile_window(fn, x, calls=20, cold=False):
    """One torch.profiler window over ``calls`` back-to-back calls (each
    after an L2 flush when ``cold``): per kernel name (the flush's left
    out) its device time in ms and its count of records, the window's
    wall time on CUDA events per call, and the names of the events seen
    when no kernel was."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.record()
        for _ in range(calls):
            if cold:
                flush_l2()
            fn(x)
        e.record()
        e.synchronize()
    kernels = {}
    events = prof.key_averages()
    for ev in events:
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type) and not is_flush(ev.key):
            ms, n = kernels.get(ev.key[:80], (0.0, 0))
            kernels[ev.key[:80]] = (ms + us / 1e3, n + ev.count)
    seen = [] if kernels else sorted({ev.key[:60] for ev in events})[:12]
    return kernels, s.elapsed_time(e) / calls, seen


def profile_calls(fn, x, calls=20, windows=WINDOWS, cold=False):
    """``windows`` profile windows (:func:`profile_window`).  The profiler
    drops some kernel records in some windows, so a window's device time
    per call is, per kernel name, its mean time a record times its
    launches a call (the most records any window holds, over ``calls``).
    Returns the median over the windows and its spread, the median window
    time and idle share (warm windows only: a cold window's wall time
    holds the flushes), the ten costliest kernels of the median window,
    how many windows were short of records, and the events a window
    without any kernel saw."""
    import torch
    if cold:
        flush_l2()      # its first call profiles itself: not inside a window
    fn(x)
    torch.cuda.synchronize()
    runs = [profile_window(fn, x, calls, cold) for _ in range(windows)]
    most = {}
    for k, _w, _s in runs:
        for key, (_ms, n) in k.items():
            most[key] = max(most.get(key, 0), n)
    per_call = {key: max(round(n / calls), 1) for key, n in most.items()}
    est = []
    for k, w, _s in runs:
        if k:
            ms = {key: t / n * per_call[key] for key, (t, n) in k.items()}
            est.append((sum(ms.values()), ms, w))
    est.sort(key=lambda r: r[0])
    empty = [seen for k, _w, seen in runs if not k]
    rec = {"windows": windows, "records_a_call": sum(per_call.values()),
           "short_windows": sum(any(k.get(key, (0, 0))[1] < n
                                    for key, n in most.items())
                                for k, _w, _s in runs)}
    if empty:
        rec["empty_window_events"] = empty[0]
    if not est:
        return {**rec, "device_ms": "not measured",
                "idle_share": "not measured", "window_ms": "not measured"}
    rec.update(device_ms=statistics.median(b for b, _k, _w in est),
               device_ms_spread=[est[0][0], est[-1][0]],
               kernels_ms=dict(sorted(est[len(est) // 2][1].items(),
                                      key=lambda kv: -kv[1])[:10]))
    if not cold:
        rec.update(window_ms=statistics.median(w for _b, _k, w in est),
                   idle_share=statistics.median(1 - b / w
                                                for b, _k, w in est
                                                if w > 0))
    return rec


def family_streams(plan):
    """The placed streams of a plan (a COO2 plan: pass 1, then R), each
    with the columns of x it reads: a stripe's slice, a graph plan's part
    (``graph_part_inputs``), else None."""
    if "graph" in plan:
        return ([(plan["heavy"]["sell8w_v2"], "heavy")] if "heavy" in plan
                else []) + [(plan["light"]["sell8d"], "light")]
    if "hybrid" in plan:
        return [s for p in plan["hybrid"] for s in family_streams(p)]
    if "coo2" in plan:
        return [(plan["coo2"], None), (plan["coo2"].reduce, None)]
    if "sell_cs" in plan:
        return [(plan["sell_cs"], None)]
    if "csr_split" in plan:
        return [(plan["csr_split"], None)]
    if "sell8d_stripes" in plan:
        return [(st, slice(lo, hi))
                for lo, hi, _vis, st in plan["sell8d_stripes"]]
    for key in ("sell8d", "sell8w_v2", "sell8w_v2w", "dia"):
        if key in plan:
            return [(plan[key], None)]
    return []


def keep_kernel(kern, k, rec, stream, family):
    """Keep a kernel's numbers at its largest stream."""
    kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], rec["max_abs_err"])
    size = (stream.data.numel() if is_dia(stream)
            else stream.vals.numel() if is_cs(stream) or is_split(stream)
            else stream.meta.numel())
    if size >= kern[k].get("size", -1):
        kern[k].update(size=size, family=family, **{
            f: rec[f] for f in ("ms", "cold_ms", "device_ms",
                                "device_ms_spread", "cold_device_ms",
                                "cold_device_ms_spread", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "library_call", "bytes", "stream_bound_ms",
                                "stream_bytes")})


def stream_record(stream, rec):
    """A stream's line in a family's ``streams``."""
    return {"kernel": kernel_of(stream), "value_mode": value_mode_of(stream),
            "nw": getattr(stream, "nw", None),
            "cell_w": getattr(stream, "cell_w", None),
            "g": getattr(stream, "g", None), "n": stream.n,
            "chunks": getattr(stream, "nchunks", None),
            "tiles": (None if is_dia(stream) or is_cs(stream)
                      else stream.meta.shape[0]),
            **rec}


def value_mode_of(stream):
    """A stream's value mode, or its values' type where it has none."""
    vm = getattr(stream, "value_mode", None)
    if vm:
        return vm
    vals = stream.data if is_dia(stream) else stream.vals
    return str(vals.dtype).replace("torch.", "")


def reference(a, xh, np):
    """(reference y, (|A||x|)_i, bound, the reference's name) on the host:
    spmv_golden for f32, row-by-row f64 sums for f64."""
    import spmv_tpu_torch as st
    if a.vals.dtype != np.float64:
        absref = st.spmv_golden(
            st.CsrMatrix(a.m, a.n, a.rowptr, a.colidx, np.abs(a.vals)),
            np.abs(xh))
        return st.spmv_golden(a.astype(np.float64), xh), absref, BOUND, \
            "spmv_golden"
    prod = a.vals * xh[a.colidx]
    rp = a.rowptr.astype(np.int64)
    full = rp[1:] > rp[:-1]
    y, absref = np.zeros(a.m), np.zeros(a.m)
    y[full] = np.add.reduceat(prod, rp[:-1][full])
    absref[full] = np.add.reduceat(np.abs(prod), rp[:-1][full])
    return y, absref, BOUND_F64, "rowwise_f64"


def scan_atol(h, a, ref):
    """The absolute term of a scan plan's bound (0 for other plans): a row
    is a difference of two prefix sums, so its error is absolute; the dist
    scan's term in f32, tests/test_methods.py's in f64."""
    from spmv_tpu_torch.handle import plan_kind
    if plan_kind(h.plan) not in SCAN_KINDS:
        return 0.0
    if a.vals.dtype != "float64":
        return 2e-4 * (a.nnz / 150_000) ** 0.5
    return 1e-10 * max(float(ref.abs().max()), 1.0)


def bcsr_tf32(h, x, ref, absref, bound):
    """The BCSR plan once more with TensorFloat-32 switched on for every
    matmul: it must still meet ``bound``.  Beside it, the scaled error of
    the same block products as one ``torch.bmm`` under TF32 (reported):
    what a matmul would give a caller who turned TF32 on."""
    import torch
    p = h.plan
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = h(x).cpu()
        xb = torch.cat([x, x.new_zeros(-x.numel() % 128)]).view(-1, 128)
        part = torch.bmm(p["blocks"].float(),
                         xb[p["block_cols"]].unsqueeze(2)).squeeze(2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    y_bmm = torch.zeros(p["nblock_rows"], 128, device=x.device).index_add_(
        0, p["block_rows"], part).view(-1)[:h.m].cpu()
    rel, _, ok = scaled_err(y, ref, absref, bound)
    if not ok:
        raise AssertionError(f"BCSR with TF32 on: max scaled error "
                             f"{rel:.3g}")
    return {"tf32_scaled_err": rel,
            "tf32_bmm_scaled_err": scaled_err(y_bmm, ref, absref,
                                              bound)[0]}


def main_path(dev, kern, gpu):
    import numpy as np
    import torch
    import spmv_tpu_torch as st
    from spmv_tpu_torch.formats import coo2 as coo2_fmt
    from spmv_tpu_torch.formats import reorder as reorder_fmt
    from spmv_tpu_torch.handle import (graph_part_inputs, light_part_input,
                                       plan_kind)
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.ops import coo2 as coo2_ops
    from spmv_tpu_torch.utils.profiling import predeal_profile

    handles, xs, mats, pre, made = {}, {}, {}, {}, {}
    for name, (make, kind, vmode, _k) in FAMILIES.items():
        t0 = time.perf_counter()
        if make not in made:        # the plain run reuses powerlaw100k
            made[make] = make(generate, np)
        a = made[make]
        t_gen = time.perf_counter() - t0
        log_matrix(name, a)
        method = method_of(name)
        vec, reorder, resolved = PLAIN_FAMILIES.get(
            name, (None, "VPU", None, None))[1:]
        reorder_s = None
        if reorder:
            # the host's time for the reorder alone (a Python BFS)
            t0 = time.perf_counter()
            reorder_fmt.rcm_order(a)
            reorder_s = time.perf_counter() - t0
        native_packs = coo2_fmt.packs["native"]
        t0 = time.perf_counter()
        with predeal_profile() as laps:
            h = st.create_handle(a, method=getattr(st.Method, method),
                                 vectorized=getattr(st.VectorizedWay, vec),
                                 reorder=reorder, device=dev)
        predeal = time.perf_counter() - t0
        got = plan_kind(h.plan).replace("+rest", "")
        if got != kind or h.plan.get("value_mode") != vmode:
            raise AssertionError(f"{name}: {method} planned {got} "
                                 f"({h.plan.get('value_mode')}), expected "
                                 f"{kind} ({vmode})")
        if name in CSR5_FAMILIES and h.method != st.Method.CSR5:
            raise AssertionError(f"{name}: {method} resolved to "
                                 f"{h.method_name}, not Method.CSR5")
        if resolved and h.method != getattr(st.Method, resolved):
            raise AssertionError(f"{name}: {method} resolved to "
                                 f"{h.method_name}, not {resolved}")
        if (name in LARGE_N_FAMILIES
                and h.plan.get("nw") != LARGE_N_FAMILIES[name][1]):
            raise AssertionError(f"{name}: nw {h.plan.get('nw')}, expected "
                                 f"{LARGE_N_FAMILIES[name][1]}")
        if kind == "coo2" and coo2_fmt.packs["native"] != native_packs + 1:
            raise AssertionError(f"{name}: the COO2 pack did not come from "
                                 f"the native packer ({coo2_fmt.packs})")
        if (name.endswith("_f64") and kind.startswith("hybrid")
                and not h.plan["hybrid"][0].get("fold_planes_ext")):
            raise AssertionError(f"{name}: the f64 hybrid does not fold "
                                 "by x-extension")
        handles[name], mats[name] = h, a
        xs[name] = torch.from_numpy(np.random.default_rng(0)
                                    .standard_normal(a.n)
                                    .astype(a.vals.dtype)).to(dev)
        pre[name] = {"method": method, "resolved": h.method_name,
                     "gen_ms": t_gen * 1e3,
                     "pack_ms": (predeal - laps["transfer_s"]) * 1e3,
                     "transfer_ms": laps["transfer_s"] * 1e3,
                     "plan_mb": laps["bytes"] / 1e6}
        if kind == "coo2":
            pre[name].update(packer="native", pad1=h.plan["pad1"],
                             pad2=h.plan["pad2"])
        if name in PLAIN_FAMILIES:
            pre[name].update(vectorized=vec, reorder=reorder,
                             reorder_s=reorder_s)
        log(f"# {name}: {h!r} predeal {predeal * 1e3:.0f} ms")

    del made
    # the counted runs, one a path (f32 AUTO, f64 AUTO, CSR5, large n, the
    # plain plans): every count to 0, the path's families once, the counts
    # read back; a kernel's launches add up over the paths
    launches, ys = {k: 0 for k in KERNELS}, {}
    for path in ("f32", "f64", "csr5", "large_n", "plain"):
        names = [n for n in FAMILIES if path_of(n) == path]
        zero_counts()
        for name in names:
            ys[name] = st.spmv(handles[name], xs[name])
        torch.cuda.synchronize()
        counts = read_counts()
        log(json.dumps({"phase": "main_path_launches", "path": path,
                        **counts}))
        for name in names:
            for k in FAMILIES[name][3]:
                if counts[k] == 0:
                    raise AssertionError(f"{name}: kernel {k} was not "
                                         "launched")
        for k, c in counts.items():
            launches[k] += c

    windowed_ctx, prices_ctx = {}, {}
    for name, h in handles.items():
        a, x = mats[name], xs[name]
        xh = x.cpu().numpy().astype(np.float64)
        ref, absref, bound, ref_name = reference(a, xh, np)
        ref, absref = torch.from_numpy(ref), torch.from_numpy(absref)
        y = ys.pop(name).cpu()
        if (y.shape != (a.m,) or y.dtype != x.dtype
                or not bool(torch.isfinite(y).all())):
            raise AssertionError(f"{name}: bad output {y.dtype} "
                                 f"{tuple(y.shape)}")
        atol = scan_atol(h, a, ref)
        rel, mabs, ok = scaled_err(y, ref, absref, bound, atol)
        if not ok:
            raise AssertionError(f"{name}: max scaled error {rel:.3g} "
                                 f"against {ref_name}")
        repeats_its_y(name, h, x)
        if name in STREAM_FAMILIES:
            streams_check(name, h, x)
        gold = torch.from_numpy(st.spmv_golden(a.astype(np.float64), xh))
        rel_gold = scaled_err(y, gold, absref, bound, atol)[0]
        gold_self = scaled_err(gold, ref, absref, bound)[0]
        del gold
        extra = {}
        if plan_kind(h.plan) == "bcsr":
            extra = bcsr_tf32(h, x, ref, absref, bound)
        ms = cuda_ms(h, x)
        with plain_kernels() as bind:
            h_plain = bind(h)
            y_plain = h_plain(x)
            plain_ms = cuda_ms(h_plain, x)
        rel_p, _, ok_p = scaled_err(y_plain.cpu(), ref, absref, bound, atol)
        if not ok_p:
            raise AssertionError(f"{name}: plain path scaled error "
                                 f"{rel_p:.3g}")
        del y_plain
        csr = matrix_csr(a, dev)
        library_ms = cuda_ms(lambda v: csr @ v, x)
        rel_lib = scaled_err((csr @ x).cpu(), ref, absref, bound)[0]
        del csr
        prof = profile_calls(h, x)
        streams = []
        parts = graph_part_inputs(h, x) if "graph" in h.plan else {}
        # a reordered plan reads x permuted
        xp = x if h.perm is None else x[torch.from_numpy(h.perm).to(dev)]
        for stream, cols in family_streams(h.plan):
            k = kernel_of(stream)
            if k == "sell_row_bin":
                # COO2's pass 2 reads the pass-1 product stream
                xin = coo2_ops.coo2_pass1_plain(h.plan["coo2"],
                                                x)[:stream.n]
            elif isinstance(cols, str):
                xin = parts[cols]           # a graph plan's part
            elif cols is not None:
                xin = x[cols]               # a column stripe's slice
            elif stream.n == a.n:
                xin = xp
            else:
                # the f64 hybrid's light part reads x extended by the
                # dense part's output
                xin = light_part_input(h, x)
            rec = check_stream(stream, xin, timing=True)
            keep_kernel(kern, k, rec, stream, name)
            streams.append(stream_record(stream, rec))
        nnz = a.nnz
        log(json.dumps({
            "family": name, "plan": plan_kind(h.plan),
            "value_mode": h.plan.get("value_mode"),
            "nw": h.plan.get("nw"), "m": a.m, "n": a.n, "nnz": nnz,
            **pre[name], "ms": ms, "gflops": 2 * nnz / ms / 1e6,
            "plain_ms": plain_ms, "plain_gflops": 2 * nnz / plain_ms / 1e6,
            "library_ms": library_ms, "library_gflops":
            2 * nnz / library_ms / 1e6, "reference": ref_name,
            "max_scaled_err": rel, "max_abs_err": mabs, "atol": atol,
            "golden_scaled_err": rel_gold, "golden_vs_reference": gold_self,
            "plain_scaled_err": rel_p, "library_scaled_err": rel_lib,
            **extra, "profile": prof, "streams": streams}))
        if name in WINDOWED_FORMS:
            windowed_ctx[name] = (h, a, x, ref, absref, bound)
        if name in PRICE_FAMILIES:
            prices_ctx[name] = (h, a, x, ref, absref, bound)
    for k, c in bf16_phase(dev, kern, gpu, handles, mats, xs, pre).items():
        launches[k] += c
    return launches, windowed_ctx, prices_ctx


def bf16_phase(dev, kern, gpu, handles, mats, xs, pre):
    """The bf16 matrices (``BF16_FAMILIES``, ``BF16_DIST``): each main-path
    matrix rounded to bf16 and planned by AUTO, its route asserted, one
    counted run, then per family y against the decoded matrix's reference
    and the times beside its f32 handle's and cuSPARSE's.  Returns the
    run's counts."""
    import numpy as np
    import torch
    import spmv_tpu_torch as st
    from spmv_tpu_torch.handle import plan_kind
    from spmv_tpu_torch.parallel import build_dist_auto, make_mesh_1d
    from spmv_tpu_torch.utils.profiling import predeal_profile

    t_phase = time.perf_counter()
    hs, decoded, recs = {}, {}, {}
    for name, (src, method, kind, _k) in BF16_FAMILIES.items():
        t0 = time.perf_counter()
        a = mats[src].astype(torch.bfloat16)
        t_cast = time.perf_counter() - t0
        t0 = time.perf_counter()
        with predeal_profile() as laps:
            h = st.create_handle(a, device=dev)
        predeal = time.perf_counter() - t0
        got = plan_kind(h.plan)
        if (h.dtype != torch.bfloat16 or got not in BF16_KINDS
                or (kind and (got, h.method) != (kind,
                                                  getattr(st.Method,
                                                          method)))):
            raise AssertionError(f"{name}: AUTO planned {got} "
                                 f"({h.method_name}, {h.dtype}), expected "
                                 f"{kind} ({method})")
        if src == "powerlaw100k" and h.plan.get("sell_fallback") != "scan":
            raise AssertionError(f"{name}: not the chunked SELL's scan "
                                 "fall-back")
        hs[name], decoded[name] = h, a.astype(np.float32)
        recs[name] = {"source": src, "method": h.method_name, "plan": got,
                      "sell_fallback": h.plan.get("sell_fallback"),
                      "f32_method": handles[src].method_name,
                      "f32_plan": plan_kind(handles[src].plan),
                      "cast_ms": t_cast * 1e3,
                      "pack_ms": (predeal - laps["transfer_s"]) * 1e3,
                      "transfer_ms": laps["transfer_s"] * 1e3,
                      "plan_mb": laps["bytes"] / 1e6,
                      "f32_plan_mb": pre[src]["plan_mb"]}
        log(f"# {name}: {h!r} predeal {predeal * 1e3:.0f} ms")
    dname, dsrc, nd, dkind = BF16_DIST
    t0 = time.perf_counter()
    dplan = build_dist_auto(mats[dsrc].astype(torch.bfloat16),
                            make_mesh_1d(nd, device=dev))
    d_predeal = time.perf_counter() - t0
    if dplan.kind != dkind:
        raise AssertionError(f"{dname}: build_dist_auto gave {dplan.kind}, "
                             f"expected {dkind}")

    # the counted run: every count to 0, each family once, read back
    zero_counts()
    ys = {name: st.spmv(h, xs[BF16_FAMILIES[name][0]])
          for name, h in hs.items()}
    ys[dname] = dplan(xs[dsrc])
    torch.cuda.synchronize()
    counts = read_counts()
    log(json.dumps({"phase": "main_path_launches", "path": "bf16",
                    **counts}))
    for name, (_s, _m, _k, kernels) in BF16_FAMILIES.items():
        for k in kernels:
            if counts[k] == 0:
                raise AssertionError(f"{name}: kernel {k} was not launched")

    def held(name, y, dec, x, fn, atol):
        """The record of y = fn(x): y against the reference of ``dec`` (the
        decoded matrix) within its bound plus ``atol``, and the times."""
        xh = x.cpu().numpy().astype(np.float64)
        ref, absref, bound, ref_name = reference(dec, xh, np)
        ref, absref = torch.from_numpy(ref), torch.from_numpy(absref)
        y = y.cpu()
        if (y.shape != (dec.m,) or y.dtype != torch.float32
                or not bool(torch.isfinite(y).all())):
            raise AssertionError(f"{name}: bad output {y.dtype} "
                                 f"{tuple(y.shape)}")
        rel, mabs, ok = scaled_err(y, ref, absref, bound, atol)
        if not ok:
            raise AssertionError(f"{name}: max scaled error {rel:.3g} "
                                 f"against {ref_name}")
        return {"reference": ref_name, "bound": bound, "atol": atol,
                "max_scaled_err": rel, "max_abs_err": mabs,
                "ms": cuda_ms(fn, x), "profile": profile_calls(fn, x)}

    for name, h in hs.items():
        src = BF16_FAMILIES[name][0]
        dec, x, h32 = decoded.pop(name), xs[src], handles[src]
        rec = held(name, ys.pop(name), dec, x, h, scan_atol(h, dec, None))
        repeats_its_y(name, h, x)
        y, y32 = h(x), h32(x)
        rec["same_y_as_f32"] = bool(torch.equal(y, y32))
        # the f32 handle repeats its own y bit for bit, or the run fails
        rec["f32_repeats_its_y"] = repeats_its_y(f"{src} (f32)", h32, x)
        del y, y32
        rec["f32_ms"] = cuda_ms(h32, x)
        rec["ms_over_f32"] = rec["ms"] / rec["f32_ms"]
        csr = matrix_csr(dec, dev)
        rec["library_ms"] = cuda_ms(lambda v: csr @ v, x)
        del csr
        if src == "banded4m":
            # the dyadic band: the f32 plan's diagonals are lossless bf16
            # already, so both handles hold the same plan and give the
            # same y; the bf16 stream's kernel against its plain version
            d16, d32 = h.plan["dia"], h32.plan["dia"]
            if (not rec["same_y_as_f32"] or d16.offsets != d32.offsets
                    or d16.data.dtype != torch.bfloat16
                    or not torch.equal(d16.data, d32.data)
                    or recs[name]["plan_mb"] != recs[name]["f32_plan_mb"]):
                raise AssertionError(f"{name}: not the f32 handle's plan "
                                     "and y bit for bit")
            k = check_stream(d16, x)
            kern["dia"]["max_abs_err"] = max(kern["dia"]["max_abs_err"],
                                             k["max_abs_err"])
            rec["kernel_max_abs_err"] = k["max_abs_err"]
        log(json.dumps({"phase": "bf16", "family": name, "gpu": gpu,
                        "m": dec.m, "n": dec.n, "nnz": dec.nnz,
                        **recs[name], **rec}))
        del dec
    a = mats[dsrc].astype(np.float32)
    shard_nnz = max(int(t.numel()) for t in dplan.parts["scan"].vals_pad)
    rec = held(dname, ys.pop(dname), a, xs[dsrc], dplan,
               2e-4 * (shard_nnz / 150_000) ** 0.5)
    repeats_its_y(dname, dplan, xs[dsrc])
    rec["single_ms"] = cuda_ms(hs[f"{dsrc}_bf16"], xs[dsrc])
    log(json.dumps({"phase": "bf16", "family": dname, "gpu": gpu,
                    "source": dsrc, "kind": dplan.kind,
                    "x_mode": dplan.x_mode, "shards": nd,
                    "predeal_ms": d_predeal * 1e3, "m": a.m, "n": a.n,
                    "nnz": a.nnz, **rec}))
    log(json.dumps({"phase": "bf16_wall", "seconds":
                    time.perf_counter() - t_phase}))
    return counts


def windowed_slot_plan(a):
    """``a`` as one windowed slot stream (K6, K7 slot), as the JAX planner
    packs it when its gate vetoes the stripes: ``pack_sell8d`` with the nw
    of ``estimate_sell8d_auto(windowed=True)`` and the striped spill
    budget."""
    import numpy as np
    from spmv_tpu_torch import handle as th
    from spmv_tpu_torch.formats.sell8d import (MAX_SPILL_STRIPED,
                                               estimate_sell8d_auto,
                                               pack_sell8d,
                                               slot_stream_budget)
    df = a.vals.dtype == np.float64
    _t, _c, _sp, nw = estimate_sell8d_auto(
        a, nw=None, windowed=True, max_spill=MAX_SPILL_STRIPED)
    allow = th._pad_allow(
        32.0, slot_stream_budget(a.vals, nw, df) / max(a.nnz, 1))
    packed, rest = pack_sell8d(a, max_pad_ratio=allow, nw=nw, g="auto",
                               max_spill=MAX_SPILL_STRIPED, cell_w=nw > 1)
    plan = {"sell8d": packed, "pad_ratio": packed.pad_ratio}
    if rest is not None:
        plan.update(rest_rows=rest[0], rest_cols=rest[1], rest_vals=rest[2])
    return plan


def windowed_row_plan(a):
    """``a`` as a ``sell8w_v2w`` row stream (K5 values, K7 row):
    ``pack_sell8w`` at ``max_pad_ratio=8`` and ``plan_v2``, f64 packed
    twice, hi and lo."""
    import numpy as np
    from spmv_tpu_torch.formats import sell8w as s8w
    from spmv_tpu_torch.types import CsrMatrix
    packed = s8w.pack_sell8w(a, max_pad_ratio=8.0)
    lo = None
    if a.vals.dtype == np.float64:
        lo = s8w.pack_sell8w(CsrMatrix(
            a.m, a.n, a.rowptr, a.colidx,
            (a.vals - a.vals.astype(np.float32).astype(np.float64))
            .astype(np.float32))).vals
    return {"sell8w_v2w": s8w.plan_v2(packed, lo_tiles=lo),
            "pad_ratio": packed.pad_ratio}


def windowed_phase(dev, kern, ctx):
    """The windowed forms of the striped families at full size: one
    windowed slot stream (:func:`windowed_slot_plan`) and a ``sell8w_v2w``
    row stream (:func:`windowed_row_plan`).  Each form's y against the
    family's reference, its stream against its plain version, and its time
    beside the striped plan's, per call and on the card, timed in turns
    (striped, windowed, windowed, striped)."""
    from spmv_tpu_torch import handle as th
    from spmv_tpu_torch.types import Method

    rows = []
    for name, (h, a, x, ref, absref, bound) in ctx.items():
        forms = [("sell8d windowed", windowed_slot_plan)]
        if name in ROW_FORMS:
            forms.append(("sell8w_v2w", windowed_row_plan))
        for form, build in forms:
            t0 = time.perf_counter()
            plan = build(a)
            pack_s = time.perf_counter() - t0
            placed = th._place(plan, dev)
            fn = th._make_bound(Method.SELL_C_SIGMA, placed, a.m)
            stream = placed.get("sell8d", placed.get("sell8w_v2w"))
            if not stream.n > 2_000_000:
                raise AssertionError(f"{name} {form}: n {stream.n}")
            y = fn(x)
            rel, mabs, ok = scaled_err(y.cpu(), ref, absref, bound)
            if not ok:
                raise AssertionError(f"{name} {form}: max scaled error "
                                     f"{rel:.3g} against the reference")
            repeats_its_y(f"{name} {form}", fn, x)
            striped_ms = [cuda_ms(h, x)]
            ms = [cuda_ms(fn, x), cuda_ms(fn, x)]
            striped_ms.append(cuda_ms(h, x))
            prof_striped, prof = profile_calls(h, x), profile_calls(fn, x)
            rec = check_stream(stream, x, timing=True)
            keep_kernel(kern, kernel_of(stream), rec, stream,
                        f"{name} ({form})")
            row = {"phase": "windowed", "family": name, "form": form,
                   "kernel": kernel_of(stream), "pack_s": pack_s,
                   "pad_ratio": plan["pad_ratio"],
                   "rest": len(plan.get("rest_rows", ())),
                   "ms": ms, "device_ms": prof["device_ms"],
                   "idle_share": prof["idle_share"],
                   "striped_ms": striped_ms,
                   "striped_device_ms": prof_striped["device_ms"],
                   "striped_idle_share": prof_striped["idle_share"],
                   "max_scaled_err": rel, "max_abs_err": mabs,
                   "profile": prof, "stream": stream_record(stream, rec)}
            log(json.dumps(row))
            rows.append(row)
            del placed, fn, stream, y
    return rows


def dist_streams(plan, x):
    """(stream, the x it reads, part) of every shard stream of a dist plan
    on x; the scan and DIA shards run plain PyTorch and have none."""
    import torch
    from spmv_tpu_torch.parallel import mesh as pm

    def leaf(q, xq, part):
        if isinstance(q, pm.DistSell8DColsPlan):
            xs = pm._blocks(q.mesh, pm._pad(
                pm._x_in(q.mesh, xq, q.n, q.dtype), q.cw * q.ndev))
        elif isinstance(q, (pm.DistSell8WPlan, pm.DistSell8DPlan)):
            xs = pm._assemble(q.mesh, pm._x_in(q.mesh, xq, q.n, q.dtype),
                              q.x_mode, q.halo, q.mr, q.n)
        else:
            return []
        return [(st, xd, part) for st, xd in zip(q.streams, xs)]

    p = plan.parts
    if plan.kind == "graph":
        hub = p.get("hub_cols")
        x_ext = torch.cat([x, x[hub]]) if hub is not None else x
        out = []
        if "heavy" in p:
            out += leaf(p["heavy"], x_ext, "heavy")
            x_ext = torch.cat([x_ext, p["heavy"](x_ext)])
        return out + leaf(p["light"], x_ext, "light")
    return [s for k, q in p.items() if hasattr(q, "mesh")
            for s in leaf(q, x, k)]


def dist_family_plan(name, a, mesh):
    """The plan DIST_FAMILIES gives family ``name`` on ``mesh``, its kind
    and x mode asserted."""
    from spmv_tpu_torch import parallel
    from spmv_tpu_torch.parallel.mesh import DistAutoPlan
    _base, _nd, build, kind, x_mode, _k = DIST_FAMILIES[name]
    if build == "auto":
        plan = parallel.build_dist_auto(a, mesh)
    else:
        p8w = parallel.build_dist_sell8w_plan(
            a, mesh, x_mode=build.split(":")[1], max_pad_ratio=32.0)
        plan = DistAutoPlan(kind="sell8w", x_mode=p8w.x_mode, m=a.m,
                            n=a.n, nnz=a.nnz, parts={"sell8w": p8w},
                            max_pad=p8w.max_pad)
    if (plan.kind, plan.x_mode) != (kind, x_mode):
        raise AssertionError(f"{name}: planned {plan.kind} "
                             f"{plan.x_mode}, expected {kind} {x_mode}")
    return plan


def dist_x(a):
    """The dist and multihost phases' x of matrix ``a``, on the host."""
    import numpy as np
    return np.random.default_rng(0).standard_normal(a.n).astype(
        a.vals.dtype)


def dist_phase(dev, kern, keep):
    """The mesh families on meshes of repeated ``cuda:0``: plans built and
    asserted, one counted run, then per family its check and times.  For
    the MULTIHOST_FAMILIES it keeps, in directory ``keep``, the counted
    run's y, the reference, (|A||x|)_i (``<family>.<what>.npy``) and, in
    ``single.json``, the bound, its absolute term and the per-call ms.
    Returns the counted run's launch counts."""
    import numpy as np
    import torch
    import spmv_tpu_torch as st
    from spmv_tpu_torch import parallel
    from spmv_tpu_torch.handle import plan_kind
    from spmv_tpu_torch.io import generate

    mats, plans, pre = {}, {}, {}
    for name, (base, ndev, _b, _kind, _x, _k) in DIST_FAMILIES.items():
        if base not in mats:
            mats[base] = FAMILIES[base][0](generate, np)
            log_matrix(base, mats[base])
        t0 = time.perf_counter()
        plan = dist_family_plan(name, mats[base],
                                parallel.make_mesh_1d(ndev, device=dev))
        plan_s = time.perf_counter() - t0
        plans[name] = plan
        pre[name] = {"plan_s": plan_s, "parts": {
            k: {"type": type(q).__name__,
                "x_mode": getattr(q, "x_mode", "col-shards"),
                "tiles_per_shard": getattr(q, "ntiles", None),
                "value_mode": getattr(q, "value_mode", None)}
            for k, q in plan.parts.items() if hasattr(q, "mesh")}}
        log(f"# {name}: {plan.kind} {plan.x_mode} on {ndev} shards, "
            f"planned in {plan_s:.1f} s")

    xs = {b: torch.from_numpy(dist_x(a)).to(dev) for b, a in mats.items()}
    # the counted run: every count 0, each family once, the counts read
    zero_counts()
    ys = {name: plans[name](xs[DIST_FAMILIES[name][0]]) for name in plans}
    torch.cuda.synchronize()
    counts = read_counts()
    log(json.dumps({"phase": "main_path_launches", "path": "dist",
                    **counts}))
    for name in plans:
        for k in DIST_FAMILIES[name][5]:
            if counts[k] == 0:
                raise AssertionError(f"{name}: kernel {k} was not launched")
    for k in ("sell_v1", "sell_v1_df"):
        if counts[k] == 0:
            raise AssertionError(f"the dist run launched no {k}")

    singles, kept = {}, {}
    for name, plan in plans.items():
        base, ndev = DIST_FAMILIES[name][:2]
        a, x = mats[base], xs[base]
        xh = x.cpu().numpy().astype(np.float64)
        ref, absref, bound, ref_name = reference(a, xh, np)
        ref, absref = torch.from_numpy(ref), torch.from_numpy(absref)
        y = ys.pop(name).cpu()
        if (y.shape != (a.m,) or y.dtype != x.dtype
                or not bool(torch.isfinite(y).all())):
            raise AssertionError(f"{name}: bad output {y.dtype} "
                                 f"{tuple(y.shape)}")
        d = (y.double() - ref).abs()
        atol = 0.0
        if plan.kind == "scan":
            shard_nnz = max(int(t.numel()) for t in
                            plan.parts["scan"].vals_pad)
            atol = 2e-4 * (shard_nnz / 150_000) ** 0.5
        rel = float((d / (absref + atol / bound).clamp_min(1e-300)).max())
        if not bool((d <= bound * absref + atol + 1e-300).all()):
            raise AssertionError(f"{name}: max scaled error {rel:.3g} "
                                 f"against {ref_name}")
        repeats_its_y(name, plan, x)
        if name in STREAM_FAMILIES:
            streams_check(name, plan, x)
        streams = []
        timed = set()
        for stream, xin, part in dist_streams(plan, x):
            k = kernel_of(stream)
            timing = k.startswith("sell_v1") and k not in timed
            rec = check_stream(stream, xin, timing=timing)
            if timing:
                timed.add(k)
                keep_kernel(kern, k, rec, stream, name)
            streams.append({"part": part, **stream_record(stream, rec)})
        if base not in singles:
            # the single-device AUTO plan of the same matrix
            singles[base] = st.create_handle(a, device=dev)
            repeats_its_y(f"{base} (single)", singles[base], x)
        h = singles[base]
        # in turns: mesh, single, single, mesh
        ms = [cuda_ms(plan, x)]
        single_ms = [cuda_ms(h, x), cuda_ms(h, x)]
        ms.append(cuda_ms(plan, x))
        prof = profile_calls(plan, x)
        prof_single = profile_calls(h, x)
        csr = matrix_csr(a, dev)
        library_ms = cuda_ms(lambda v: csr @ v, x)
        del csr
        log(json.dumps({
            "phase": "dist", "family": name, "kind": plan.kind,
            "x_mode": plan.x_mode, "value_mode": plan.value_mode,
            "ndev": ndev, "m": a.m, "n": a.n, "nnz": a.nnz, **pre[name],
            "ms": ms, "gflops": 2 * a.nnz / statistics.median(ms) / 1e6,
            "device_ms": prof["device_ms"], "idle_share": prof["idle_share"],
            "single_plan": plan_kind(h.plan), "single_ms": single_ms,
            "single_device_ms": prof_single["device_ms"],
            "single_idle_share": prof_single["idle_share"],
            "library_ms": library_ms, "reference": ref_name,
            "max_scaled_err": rel, "max_abs_err": float(d.max()),
            "atol": atol, "profile": prof, "streams": streams}))
        if name in MULTIHOST_FAMILIES:
            for what, v in (("y", y.numpy()), ("ref", ref.numpy()),
                            ("absref", absref.numpy())):
                np.save(os.path.join(keep, f"{name}.{what}.npy"), v)
            kept[name] = {"bound": bound, "atol": atol, "single_ms": ms}
        if not any(DIST_FAMILIES[n][0] == base for n in ys):
            singles.pop(base, None)     # no later family reads it
    with open(os.path.join(keep, "single.json"), "w") as f:
        json.dump(kept, f)
    return counts


def multihost_rank(rank, port, work):
    """One rank of the multihost phase (``chip_smoke.py --multihost-rank
    RANK PORT DIR``): gloo over ``tcp://localhost:PORT``, two ranks of two
    shards on ``cuda:0``.  Builds each of MULTIHOST_FAMILIES as the dist
    phase does, runs it once with the launch counts zeroed before and read
    after (the family's kernels must launch on this rank), holds y bit for
    bit to the dist phase's single-controller y and within its bound of
    the reference (both from DIR), counts the bytes this rank sends in one
    call, and times calls (CUDA events, the ranks aligned by a barrier
    before each) and, beside them, the transport alone: one gloo
    all-gather of as many host bytes (host clock).  Writes
    ``rank<RANK>.json`` into DIR."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.parallel import mesh as pm
    from spmv_tpu_torch.parallel.multihost import (global_mesh_1d,
                                                   init_distributed)
    dev = torch.device("cuda", 0)
    init_distributed(init_method=f"tcp://localhost:{port}", world_size=2,
                     rank=rank, backend="gloo", device=dev)
    mesh = global_mesh_1d(device=dev, local_shards=2)
    if mesh.ranks != (0, 0, 1, 1):
        raise AssertionError(f"mesh ranks {mesh.ranks}")
    with open(os.path.join(work, "single.json")) as f:
        kept = json.load(f)
    mats, out = {}, {"rank": rank, "counts": dict.fromkeys(KERNELS, 0),
                     "families": {}}
    for name in MULTIHOST_FAMILIES:
        base, kernels = DIST_FAMILIES[name][0], DIST_FAMILIES[name][5]
        if base not in mats:
            mats[base] = FAMILIES[base][0](generate, np)
        a = mats[base]
        t0 = time.perf_counter()
        plan = dist_family_plan(name, a, mesh)
        plan_s = time.perf_counter() - t0
        x = torch.from_numpy(dist_x(a)).to(dev)
        dist.barrier()
        zero_counts()
        y = plan(x).cpu().numpy()
        counts = read_counts()
        for k in kernels:
            if counts[k] == 0:
                raise AssertionError(f"rank {rank} {name}: kernel {k} was "
                                     "not launched")
        for k, c in counts.items():
            out["counts"][k] += c
        want = np.load(os.path.join(work, f"{name}.y.npy"))
        if y.dtype != want.dtype or y.tobytes() != want.tobytes():
            diff = np.abs(y.astype(np.float64) - want)
            raise AssertionError(
                f"rank {rank} {name}: {int((diff > 0).sum())} of {y.size} "
                f"entries differ from the single-controller y, max "
                f"{float(diff.max()):.3g}")
        ref, absref = (np.load(os.path.join(work, f"{name}.{w}.npy"))
                       for w in ("ref", "absref"))
        bound, atol = kept[name]["bound"], kept[name]["atol"]
        d = np.abs(y.astype(np.float64) - ref)
        if not (d <= bound * absref + atol + 1e-300).all():
            raise AssertionError(f"rank {rank} {name}: outside its bound")
        sent = pm.sent_bytes
        plan(x)
        torch.cuda.synchronize()
        sent = pm.sent_bytes - sent
        for _ in range(3):
            plan(x)
        torch.cuda.synchronize()
        times = []
        for _ in range(ITERS):
            dist.barrier()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            plan(x)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        # the transport alone: one all-gather over gloo of a host tensor
        # of the bytes this rank sends a call, timed the same way
        buf = torch.zeros(max(sent // 4, 1), dtype=torch.float32)
        bufs = [torch.empty_like(buf) for _ in range(2)]
        gloo_ms = []
        for i in range(3 + ITERS):
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_gather(bufs, buf)
            if i >= 3:
                gloo_ms.append((time.perf_counter() - t0) * 1e3)
        out["families"][name] = {"plan_s": plan_s, "ms": times,
                                 "sent_bytes": sent, "gloo_ms": gloo_ms}
        del plan, x
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    print(f"rank{rank} DONE", flush=True)
    return 0


def multihost_phase(work):
    """MULTIHOST_FAMILIES on two rank processes (``multihost_rank``) of
    two shards each on ``cuda:0``, over gloo: one card cannot hold two
    NCCL ranks, so this times the port's host staging, not NCCL.  A rank
    that exits non-zero or runs past RANK_TIMEOUT fails the phase (the
    other is stopped, each rank's log tail printed).  Logs one line a
    family: the median ms a call on each rank and the maximum over ranks,
    beside the single-controller plan's, the bytes a call moves between
    the ranks and the median ms of one gloo all-gather of as many host
    bytes on each rank.  Returns the ranks' launch counts, added."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--multihost-rank", str(r), str(port), work],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=ROOT) for r in (0, 1)]
    try:
        while any(p.poll() is None for p in procs):
            late = time.perf_counter() - t0 > RANK_TIMEOUT
            if late or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            for q in (0, 1):
                with open(os.path.join(work, f"rank{q}.log")) as f:
                    log(f"# rank {q} (exit {procs[q].returncode}, "
                        f"{wall:.1f} s):\n{f.read()[-4000:]}")
            raise AssertionError(f"multihost rank {r} exited "
                                 f"{p.returncode} after {wall:.1f} s")
    ranks = []
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(work, "single.json")) as f:
        kept = json.load(f)
    for rk in ranks:
        log(json.dumps({"phase": "main_path_launches", "path": "multihost",
                        "rank": rk["rank"], **rk["counts"]}))
    for name in MULTIHOST_FAMILIES:
        fam = [rk["families"][name] for rk in ranks]
        med = [statistics.median(f["ms"]) for f in fam]
        log(json.dumps({
            "phase": "multihost", "family": name, "backend": "gloo",
            "ranks": 2, "shards": 4, "device": "cuda:0 (both ranks)",
            "plan_s": [f["plan_s"] for f in fam], "ms_rank0": med[0],
            "ms_ranks": med, "ms_max": max(med),
            "single_ms": kept[name]["single_ms"],
            "sent_bytes": [f["sent_bytes"] for f in fam],
            "bytes_between_ranks": sum(f["sent_bytes"] for f in fam),
            "gloo_ms": [statistics.median(f["gloo_ms"]) for f in fam]}))
    log(json.dumps({"phase": "multihost", "seconds": wall}))
    return {k: sum(rk["counts"][k] for rk in ranks) for k in KERNELS}


#: the tools phase: tune's chain iterations and repeats a candidate; the
#: HPCG grid (hpcg.dat's 104³) and cg's iterations (one HPCG set); the
#: kernels its counted run must launch (SELL-8D slot streams for tune and
#: power_iteration, DIA for the suite's banded1m, f64 DIA for cg)
TUNE_ITERS, TUNE_REPEATS = 5, 2
HPCG_NX = 104
CG_ITERS = 50
TOOLS_KERNELS = ("sell_slot", "dia", "dia_f64")


def hpcg_matrix(nx, np):
    """HPCG's reference problem: the 27-point stencil on an nx³ grid,
    26 on the diagonal and -1 for each neighbour, in f64; each row's
    columns ascend, as the offsets are taken in ascending order."""
    from spmv_tpu_torch.types import CsrMatrix
    n = nx ** 3
    i = np.arange(n, dtype=np.int64)
    z, y, x = i // (nx * nx), (i // nx) % nx, i % nx
    cols = np.empty((n, 27), np.int64)
    ok = np.empty((n, 27), bool)
    k = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cols[:, k] = i + (dz * nx + dy) * nx + dx
                ok[:, k] = ((z + dz >= 0) & (z + dz < nx) & (y + dy >= 0)
                            & (y + dy < nx) & (x + dx >= 0) & (x + dx < nx))
                k += 1
    lengths = ok.sum(1)
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=rowptr[1:])
    colidx = cols[ok]
    vals = np.where(colidx == np.repeat(i, lengths), 26.0, -1.0)
    return CsrMatrix(n, n, rowptr.astype(np.int32), colidx.astype(np.int32),
                     vals)


def host_cg(s, b, iters, np):
    """The cg recurrence of ``spmv_tpu_torch.solvers.cg`` (tol = 0) in
    numpy f64 on the host, over a scipy CSR matrix: the final
    recurrence residual ‖r‖."""
    x = np.zeros_like(b)
    r = b - s @ x
    p = r.copy()
    rs = r @ r
    for _ in range(iters):
        if not rs > 0:
            break
        ap = s @ p
        alpha = rs / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        p = r + (rs_new / rs) * p
        rs = rs_new
    return float(np.sqrt(rs))


def solve_record(run, h, x):
    """A warm solve's costs: ms an iteration (host clock around the solve,
    which ends in its own host read), its host reads, one ``spmv`` on the
    same handle (CUDA events), and one torch.profiler window over another
    solve (device ms, idle share, costliest kernels)."""
    from spmv_tpu_torch import solvers
    solvers.host_syncs = 0
    t0 = time.perf_counter()
    _, _, it = run()
    ms = (time.perf_counter() - t0) * 1e3
    syncs = solvers.host_syncs
    kernels, window_ms, _seen = profile_window(lambda _x: run(), None, 1)
    device_ms = sum(t for t, _n in kernels.values())
    return {"iters": it, "ms": ms,
            "ms_per_iter": ms / max(it, 1), "host_syncs": syncs,
            "spmv_cuda_ms": cuda_ms(h, x), "device_ms": device_ms,
            "window_ms": window_ms,
            "idle_share": 1 - device_ms / window_ms if window_ms else None,
            "kernels_ms": {k: t for k, (t, _n) in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:6]},
            "records": sum(n for _t, n in kernels.values())}


def tools_phase(dev, gpu):
    """tune, the three solvers, the CSV suite and a Matrix Market round
    trip through the port's entry points at full size, as one counted run.
    Returns its launch counts."""
    import io
    import tempfile
    import numpy as np
    import scipy.sparse as sp
    import torch
    import spmv_tpu_torch as st
    from spmv_tpu_torch import solvers
    from spmv_tpu_torch.bench import suite, timing
    from spmv_tpu_torch.handle import plan_kind
    from spmv_tpu_torch.io import generate, mmio

    t_start = time.perf_counter()
    uniform = suite.BUILTIN_MATRICES["uniform100k"](np.float32)
    banded = suite.BUILTIN_MATRICES["banded1m"](np.float32)
    clustered = _clustered200k(generate, np)
    hpcg = hpcg_matrix(HPCG_NX, np)
    nonsym = generate.diag_plus_random(1_000_000, nnz_per_row=6,
                                       dtype=np.float32, seed=3)
    for name, a in (("uniform100k", uniform), ("banded1m", banded),
                    ("clustered200k", clustered), ("hpcg104", hpcg),
                    ("diag_plus_random1m", nonsym)):
        log_matrix(name, a)
    gen_s = time.perf_counter() - t_start

    def host(a):
        return sp.csr_matrix((a.vals.astype(np.float64), a.colidx,
                              a.rowptr), shape=(a.m, a.n))

    mark = [time.perf_counter()]

    def tool(rec):
        """Log a tools line with the seconds since the previous one."""
        now = time.perf_counter()
        log(json.dumps({"phase": "tools", "gpu": gpu, **rec,
                        "wall_s": now - mark[0]}))
        mark[0] = now

    tmp = tempfile.TemporaryDirectory()
    saved_env = os.environ.get("SPMV_TPU_TORCH_CACHE")
    os.environ["SPMV_TPU_TORCH_CACHE"] = tmp.name
    zero_counts()
    try:
        # -- tune: the default candidates on uniform100k, then the cache
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            h, results = st.tune(uniform, iters=TUNE_ITERS,
                                 repeats=TUNE_REPEATS, verbose=True,
                                 mtx_token="uniform100k", device=dev)
        sweep_s = time.perf_counter() - t0
        winner = st.METHOD_NAMES[h.requested_method]
        if results[winner] != min(results.values()):
            raise AssertionError(f"tune: winner {winner} is not the "
                                 f"minimum of {results}")
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            uniform.n).astype(np.float32)).to(dev)
        ref, absref, bound, _ = reference(uniform, x.cpu().numpy()
                                          .astype(np.float64), np)
        ref, absref = torch.from_numpy(ref), torch.from_numpy(absref)
        rel, _, ok = scaled_err(st.spmv(h, x).cpu(), ref, absref, bound,
                                scan_atol(h, uniform, ref))
        if not ok:
            raise AssertionError(f"tune's winner: scaled error {rel:.3g}")
        repeats_its_y("tune's winner", h, x)
        real_chain = timing.time_spmv_chain

        def no_sweep(*_a, **_k):
            raise AssertionError("tune's cache hit swept again")
        timing.time_spmv_chain = no_sweep
        try:
            t0 = time.perf_counter()
            h2, results2 = st.tune(uniform, iters=TUNE_ITERS,
                                   repeats=TUNE_REPEATS,
                                   mtx_token="uniform100k", device=dev)
            hit_s = time.perf_counter() - t0
        finally:
            timing.time_spmv_chain = real_chain
        if h2.method != h.method:
            raise AssertionError(f"tune's cache hit built {h2.method_name}"
                                 f", not {h.method_name}")
        tool({"tool": "tune", "matrix": "uniform100k",
              "candidates": buf.getvalue().splitlines(),
              "ms": {k: v * 1e3 for k, v in results.items()},
              "winner": winner, "resolved": h.method_name,
              "plan": plan_kind(h.plan), "max_scaled_err": rel, "sweep_s": sweep_s,
              "cache_hit_s": hit_s, "cache_hit_results": results2})
        del h, h2

        # -- cg: f64, HPCG 104³, 50 iterations with tol = 0
        t0 = time.perf_counter()
        h = st.create_handle(hpcg, device=dev)
        predeal_s = time.perf_counter() - t0
        if plan_kind(h.plan) != "dia" or h.method != st.Method.DIA:
            raise AssertionError(f"cg: AUTO planned {plan_kind(h.plan)} "
                                 f"({h.method_name}) for HPCG, not DIA")
        s = host(hpcg)
        b = s @ np.ones(hpcg.n)              # HPCG's b: A times ones
        bd = torch.from_numpy(b).to(dev)
        repeats_its_y("cg's handle", h, bd)

        def run_cg():
            return solvers.cg(h, bd, tol=0.0, maxiter=CG_ITERS)
        xd, res, it = run_cg()
        t0 = time.perf_counter()
        res_host = host_cg(s, b, CG_ITERS, np)
        host_s = time.perf_counter() - t0
        true_res = float(np.linalg.norm(b - s @ xd.cpu().numpy()))
        d_host = abs(res - res_host) / res_host
        d_true = abs(true_res - res) / res
        if it != CG_ITERS or d_host > 1e-6 or d_true > 1e-6:
            raise AssertionError(f"cg: {it} iterations, residual {res!r}, "
                                 f"host recurrence {res_host!r}, "
                                 f"|b - Ax| {true_res!r}")
        tool({"tool": "cg", "matrix": "hpcg104", "m": hpcg.m,
              "nnz": int(hpcg.nnz), "dtype": "float64",
              "plan": plan_kind(h.plan), "method": h.method_name,
              "predeal_s": predeal_s, "residual": res,
              "host_residual": res_host, "rel_diff_host": d_host,
              "true_residual": true_res, "rel_diff_true": d_true,
              "host_recurrence_s": host_s, "b_norm": float(
                  np.linalg.norm(b)), **solve_record(run_cg, h, bd)})
        del h, s, bd, xd

        # -- bicgstab: f32 diag_plus_random(1M, 6), to 1e-5·‖b‖
        t0 = time.perf_counter()
        h = st.create_handle(nonsym, device=dev)
        predeal_s = time.perf_counter() - t0
        b = np.random.default_rng(4).standard_normal(nonsym.n) \
            .astype(np.float32)
        bd = torch.from_numpy(b).to(dev)
        repeats_its_y("bicgstab's handle", h, bd)
        tol = 1e-5 * float(np.linalg.norm(b))

        def run_bicgstab():
            return solvers.bicgstab(h, bd, tol=tol)
        xd, res, it = run_bicgstab()
        true_res = float(np.linalg.norm(
            b - host(nonsym) @ xd.cpu().numpy().astype(np.float64)))
        if not (0 < it < 1000 and res <= tol and true_res <= 2 * tol):
            raise AssertionError(f"bicgstab: {it} iterations, residual "
                                 f"{res!r}, |b - Ax| {true_res!r}, tol "
                                 f"{tol!r}")
        tool({"tool": "bicgstab", "matrix": "diag_plus_random1m",
              "nnz": int(nonsym.nnz), "dtype": "float32",
              "plan": plan_kind(h.plan), "method": h.method_name,
              "predeal_s": predeal_s, "tol": tol, "residual": res,
              "true_residual": true_res,
              **solve_record(run_bicgstab, h, bd)})
        del h, bd, xd

        # -- power_iteration: clustered200k f32, 100 iterations
        t0 = time.perf_counter()
        h = st.create_handle(clustered, device=dev)
        predeal_s = time.perf_counter() - t0

        def run_power():
            lam, v = solvers.power_iteration(h, iters=100)
            return lam, v, 100
        lam, v, _ = run_power()
        repeats_its_y("power_iteration's handle", h, v)
        vh = v.cpu().numpy().astype(np.float64)
        rq = float(vh @ (host(clustered) @ vh) / (vh @ vh))
        if abs(lam - rq) > 1e-5 * abs(rq):
            raise AssertionError(f"power_iteration: λ {lam!r}, host "
                                 f"Rayleigh quotient {rq!r}")
        tool({"tool": "power_iteration", "matrix": "clustered200k",
              "dtype": "float32", "plan": plan_kind(h.plan),
              "predeal_s": predeal_s, "lambda": lam,
              "host_rayleigh": rq, "rel_diff": abs(lam - rq) / abs(rq),
              **solve_record(run_power, h, v)})
        del h, v

        # -- the CSV suite: AUTO, CSR5, SERIAL and the yardsticks
        suite_rows = {}
        for name, a in (("banded1m", banded), ("uniform100k", uniform)):
            out = io.StringIO()
            t0 = time.perf_counter()
            rows = suite.bench_matrix(
                name, a, [st.Method.AUTO, st.Method.CSR5,
                          st.Method.SERIAL], external=True, out=out,
                device=dev)
            bench_s = time.perf_counter() - t0
            xh = np.random.default_rng(0).standard_normal(a.n) \
                .astype(a.dtype)     # the x bench_matrix draws
            _, absref, bound, _ = reference(a, xh.astype(np.float64), np)
            rmse_bound = bound * float(np.sqrt(np.mean(absref ** 2)))
            for row in rows:
                f = row.split(",")
                if len(f) != 10 or not float(f[5]) <= rmse_bound:
                    raise AssertionError(f"suite row {row!r}: rmse bound "
                                         f"{rmse_bound!r}")
            if len(rows) != 5:
                raise AssertionError(f"suite on {name}: {out.getvalue()}")
            # the chain's own cost: inclusive ms of the AUTO handle beside
            # one call's CUDA-event time, and the chain with the SpMV
            # replaced by identity (only the renormalisation left)
            h = st.create_handle(a, device=dev)
            xt = torch.from_numpy(xh).to(dev)
            repeats_its_y(f"suite {name}'s AUTO handle", h, xt)
            chain = timing.time_spmv_chain(h._bound, xt)
            ident = timing.time_spmv_chain(lambda v: v, xt)
            tool({"tool": "suite", "matrix": name, "csv": rows,
                  "comments": [r for r in out.getvalue().splitlines()
                               if r.startswith("#")],
                  "rmse_bound": rmse_bound, "bench_s": bench_s,
                  "auto_plan": plan_kind(h.plan),
                  "chain_inclusive_ms": chain["inclusive"] * 1e3,
                  "chain_marginal_ms": chain["marginal"] * 1e3,
                  "chain_bubble_ms": chain["bubble"] * 1e3,
                  "spmv_cuda_ms": cuda_ms(h, xt),
                  "renorm_chain_ms": ident["inclusive"] * 1e3,
                  "renorm_share": ident["inclusive"] / chain["inclusive"]})
            suite_rows[name] = rows
            del h, xt

        # -- Matrix Market: clustered200k through write, both parsers and
        # the .npz cache
        path = os.path.join(tmp.name, "clustered200k.mtx")
        t0 = time.perf_counter()
        mmio.write_mtx(path, clustered)
        write_s = time.perf_counter() - t0
        reads = dict(mmio.reads)
        t0 = time.perf_counter()
        a_native = mmio.read_mtx(path, dtype=np.float32)
        native_s = time.perf_counter() - t0
        if mmio.reads["native"] != reads["native"] + 1:
            raise AssertionError(f"read_mtx did not parse natively "
                                 f"({mmio.reads})")
        t0 = time.perf_counter()
        a_numpy = mmio.read_mtx(path, dtype=np.float32, use_native=False)
        numpy_s = time.perf_counter() - t0
        cache = os.path.join(tmp.name, "mtx_cache")
        t0 = time.perf_counter()
        a_load = mmio.load_matrix(path, dtype=np.float32, cache_dir=cache)
        load_s = time.perf_counter() - t0
        reads = dict(mmio.reads)
        t0 = time.perf_counter()
        a_hit = mmio.load_matrix(path, dtype=np.float32, cache_dir=cache)
        hit_s = time.perf_counter() - t0
        if mmio.reads != reads:
            raise AssertionError("load_matrix's second call parsed again")
        for got in (a_native, a_numpy, a_load, a_hit):
            for k in ("rowptr", "colidx", "vals"):
                if not np.array_equal(getattr(got, k), getattr(clustered,
                                                               k)):
                    raise AssertionError(f"mmio round trip: {k} differs")
        tool({"tool": "mmio", "matrix": "clustered200k",
              "nnz": int(clustered.nnz), "file_mb": os.path.getsize(path)
              / 1e6, "write_s": write_s, "read_native_s": native_s,
              "read_numpy_s": numpy_s, "load_first_s": load_s,
              "load_hit_s": hit_s})
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        if saved_env is None:
            os.environ.pop("SPMV_TPU_TORCH_CACHE", None)
        else:
            os.environ["SPMV_TPU_TORCH_CACHE"] = saved_env
        tmp.cleanup()
    log(json.dumps({"phase": "main_path_launches", "path": "tools",
                    **counts}))
    for k in TOOLS_KERNELS:
        if counts[k] == 0:
            raise AssertionError(f"the tools run launched no {k}")
    log(json.dumps({"phase": "tools", "gpu": gpu, "generate_s": gen_s,
                    "seconds": time.perf_counter() - t_start}))
    return counts


# -- the prices phase: the probes, the calibration, the routes -------------

#: the f32 families planned under the long stream's straggler price
CHEAP_FAMILIES = ("clustered200k", "uniform100k", "powerlaw100k")
#: the families the prices phase plans under both tables: the North star's
#: nine and the large-n path's striped three
PRICE_FAMILIES = ("banded4m", "clustered200k", "uniform100k", "powerlaw100k",
                  "webbase1m", "banded1m_f64", "uniform100k_f64",
                  "clustered200k_f64", "powerlaw100k_f64",
                  "clustered2500k_s64", "clustered2500k_s64_f64",
                  "uniform250k_4m_d64")
#: the rows of clustered2500k_s64 that the windowed kernel's co-timing
#: packs at each bundle width (a quarter: four windowed packs of the whole
#: matrix would take most of the phase's time on the host)
WIDE_ROWS = 625_000


def _bound_ms(nbytes, ops=0.0):
    """(bound_ms, bound_by) of moving ``nbytes`` and doing ``ops`` f32
    operations on the H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _held(name, y, ref, absref, bound, exact=False):
    """max |y - ref|, raising unless within bound · absref (bit for bit
    with ``exact``)."""
    import torch
    y, ref = y.double().cpu(), ref.double().cpu()
    d = (y - ref).abs()
    ok = (bool(torch.equal(y, ref)) if exact else
          bool((d <= bound * absref.double().cpu() + 1e-300).all()))
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version (max abs error "
                             f"{float(d.max()):.3g})")
    return float(d.max())


def body_bytes(b):
    """The bytes a tile_body stream moves, each once: meta (where a gather
    stage or the value mode reads it) and values a slot, tinfo, ginfo, x,
    init and the output blocks."""
    slots = b.ntiles * 1024
    meta = 0 if b.gather == "none" and b.value_mode in ("f32", "bf16") \
        else 2
    val = {"f32": 4, "bf16": 2}.get(b.value_mode, 0)
    return (slots * (meta + val) + (b.tinfo.numel() + b.ginfo.numel()) * 4
            + b.x.numel() * 4 + 4096 + b.ngroups * 4096)


def _per(ms, n):
    """ns an item of ``ms`` over ``n``, or "not measured"."""
    return ms * 1e6 / n if isinstance(ms, float) else "not measured"


def probe_kernel_records(dev, mats):
    """Each probe kernel against its plain version on the card, on every
    input its probes give it (f32 sums: 1e-5 of the sum of magnitudes, the
    plain version over |values| and |x|; ``tiny`` and ``fma_err`` bit for
    bit; ``tile_stream`` and ``tile_body`` three calls bit for bit, and
    ``tile_stream`` bit for bit ``tile_stream_order``), timed on its main
    input: ``tile_stream`` on P1's S_big, ``tile_body`` on P4's f32 stream,
    ``window_gather`` on P9's loop, ``tiny`` on P6's tile, ``fma_err`` on
    P8's.  Logs ``tile_stream`` at B = 1, 8, 64, 512 beside ``torch.sum``
    and every ``tile_body`` input (and P5's full body at G 8, 16, 64),
    warm and cold, ns a tile and the bound's share of the cold time.
    Returns the kernels line's records by name."""
    import dataclasses as dc
    import numpy as np
    import torch
    from spmv_tpu_torch.bench import probes as pr, timing
    from spmv_tpu_torch.ops.sell import sm_count
    a, packed, v2 = pr.probe_inputs(mats["clustered"])
    vals = torch.from_numpy(packed.vals).to(dev)
    recs = {}
    ones = torch.ones(8, 128, dtype=torch.float32, device=dev)

    # tile_stream: every input its probes give it (P1's S_big, S_tile,
    # S_tile8 and S_nodep, P3's 512, P7's 1 and 8), each against its plain
    # version, three calls bit for bit, and bit for bit the numpy
    # statement of its summation order
    err = 0.0
    nsm = sm_count(dev)
    ones_h = np.ones((8, 128), np.float32)
    for _name, block, acc in pr.STREAM_INPUTS:
        ref = pr.tile_stream_plain(vals, block, acc, ones)
        absref = pr.tile_stream_plain(vals.abs(), block, acc, ones)
        y = pr.tile_stream(vals, block, acc, ones)
        err = max(err, _held("tile_stream", y, ref, absref, BOUND))
        repeats_its_y(f"tile_stream B {block}",
                      lambda c, b=block, a=acc: pr.tile_stream(vals, b, a, c),
                      ones)
        split = pr.stream_split(vals.shape[0] // block, block, acc, nsm)
        if not np.array_equal(y.cpu().numpy(), pr.tile_stream_order(
                packed.vals, block, acc, ones_h, split)):
            raise AssertionError(f"tile_stream B {block}: not its order's "
                                 "numpy statement bit for bit")
    nt = vals.shape[0] // 64 * 64
    bound, by = _bound_ms(nt * 4096 + 2 * 4096, nt * 1024)
    s_big = lambda c: pr.tile_stream(vals, 64, True, c)  # noqa: E731
    warm = profile_calls(s_big, ones)
    recs["tile_stream"] = dict(
        max_abs_err=err, ms=cuda_ms(s_big, ones),
        device_ms=warm["device_ms"],
        device_ms_spread=warm.get("device_ms_spread"),
        cold_ms=cuda_ms(s_big, ones, cold=True),
        plain_ms=cuda_ms(lambda c: pr.tile_stream_plain(vals, 64, True, c),
                         ones),
        library_ms=cuda_ms(lambda c: torch.sum(vals[:nt], 0), ones),
        library_call="torch.sum(tiles, 0)", bound_ms=bound, bound_by=by,
        bytes=nt * 4096 + 2 * 4096, family="clustered200k pack_sell8w "
        "tiles (P1 S_big)")
    # P3 (512 tiles a step) and P7 (1 and 8, every tile) sum the same
    # stream: one torch.sum over each one's tiles; P2, P4, P5, P8 and P9
    # have no PyTorch call that computes their function
    nt3 = vals.shape[0] // 512 * 512
    log(json.dumps({"phase": "prices", "probe_library_call":
                    "torch.sum(tiles, 0)", "probe_library_ms": {
                        "P1": recs["tile_stream"]["library_ms"],
                        "P3": cuda_ms(lambda c: torch.sum(vals[:nt3], 0),
                                      ones),
                        "P7": cuda_ms(lambda c: torch.sum(vals, 0), ones)},
                    "tiles": {"P1": nt, "P3": nt3, "P7": vals.shape[0]}}))
    # the carried stream at B = 1, 8, 64, 512 beside torch.sum over the
    # same tiles: device ms warm (the 48 MB stream sits partly in the 50 MB
    # L2) and one call's ms with the L2 cold, ns a tile, the bound's share
    # of the cold time
    for block in (1, 8, 64, 512):
        ntb = vals.shape[0] // block * block
        fn = lambda c, b=block: pr.tile_stream(vals, b, True, c)  # noqa
        lib = lambda c, n=ntb: torch.sum(vals[:n], 0)  # noqa: E731
        bnd = _bound_ms(ntb * 4096 + 2 * 4096)[0]
        kw, lw = profile_calls(fn, ones), profile_calls(lib, ones)
        cold, lcold = cuda_ms(fn, ones, cold=True), cuda_ms(lib, ones,
                                                            cold=True)
        log(json.dumps({"phase": "prices", "sweep": "tile_stream",
                        "B": block, "tiles": ntb,
                        "device_ms": kw["device_ms"], "cold_ms": cold,
                        "ns_tile_warm": _per(kw["device_ms"], ntb),
                        "ns_tile_cold": cold * 1e6 / ntb, "bound_ms": bnd,
                        "bound_share_cold": bnd / cold,
                        "torch_sum_device_ms": lw["device_ms"],
                        "torch_sum_cold_ms": lcold,
                        "split_chunks": len(pr.stream_split(
                            ntb // block, block, True, nsm).chunks)}))

    # tile_body: P2, P4's three value modes, P5's seven variants; held on
    # a random x and carry (the probes' x of ones would hide a gather at
    # the wrong column, sub-row or window), three calls bit for bit; timed
    # on the probes' own
    bodies = pr.body_inputs(packed, v2, dev)
    rng = np.random.default_rng(3)
    c0 = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)
                          ).to(dev)
    err = 0.0
    for name, b in bodies:
        b = dc.replace(b, x=torch.from_numpy(rng.standard_normal(
            b.x.numel()).astype(np.float32)).to(dev))
        babs = dc.replace(b, palette=b.palette.abs(), x=b.x.abs(),
                          vals=None if b.vals is None else b.vals.abs())
        err = max(err, _held("tile_body", pr.tile_body(b, c0),
                             pr.tile_body_plain(b, c0),
                             pr.tile_body_plain(babs, c0.abs()), BOUND))
        repeats_its_y(f"tile_body {name}",
                      lambda c, b=b: pr.tile_body(b, c), c0)
    by_name = dict(bodies)
    main = by_name["P4 f32"]
    nbytes = body_bytes(main)
    bound, by = _bound_ms(nbytes, 2 * main.ntiles * 1024)
    body = lambda c: pr.tile_body(main, c)  # noqa: E731
    warm = profile_calls(body, ones)
    recs["tile_body"] = dict(
        max_abs_err=err, ms=cuda_ms(body, ones),
        device_ms=warm["device_ms"],
        device_ms_spread=warm.get("device_ms_spread"),
        cold_ms=cuda_ms(body, ones, cold=True),
        plain_ms=cuda_ms(lambda c: pr.tile_body_plain(main, c), ones),
        library_ms=None, library_call=None, bound_ms=bound, bound_by=by,
        bytes=nbytes, family="clustered200k pack_sell8w, G 16, f32 (P4)")
    # every body input timed on the card, warm and cold (the chained P2,
    # P4 and P5 figures of the probes can be the host's enqueue time)
    for name, b in bodies:
        fn = lambda c, b=b: pr.tile_body(b, c)  # noqa: E731
        kw = profile_calls(fn, ones)
        cold = cuda_ms(fn, ones, cold=True)
        bnd = _bound_ms(body_bytes(b))[0]
        log(json.dumps({"phase": "prices", "sweep": "tile_body",
                        "input": name, "G": b.g, "tiles": b.ntiles,
                        "value_mode": b.value_mode, "gather": b.gather,
                        "mask": b.mask, "fixed_window": b.fixed_window,
                        "device_ms": kw["device_ms"], "cold_ms": cold,
                        "ns_tile_warm": _per(kw["device_ms"], b.ntiles),
                        "ns_tile_cold": cold * 1e6 / b.ntiles,
                        "bound_ms": bnd, "bound_share_cold": bnd / cold}))
    # the plain versions of the probes the kernels line does not time:
    # P2 (G 8), P3 (512 tiles a step), P5 (the full body, G 16), P7 (1
    # and 8 tiles a step, carried)
    log(json.dumps({"phase": "prices", "probe_plain_ms": {
        "P2": cuda_ms(lambda c: pr.tile_body_plain(by_name["P2 G8"], c),
                      ones),
        "P3": cuda_ms(lambda c: pr.tile_stream_plain(vals, 512, True, c),
                      ones),
        "P5": cuda_ms(lambda c: pr.tile_body_plain(by_name["P5 full G16"],
                                                   c), ones),
        "P7": [cuda_ms(lambda c, b=b: pr.tile_stream_plain(vals, b, True,
                                                           c), ones)
               for b in (1, 8)]}}))

    # window_gather: P9's loop and wide forms at the probe's g 32 and 2048
    # steps, each against its plain version and the numpy oracle, three
    # calls bit for bit and bit for bit the numpy statement of its order;
    # both timed warm and cold, ns a tile-gather.  The bound is the adds
    # of every (step, tile) gather the probe times (its ns a tile divides
    # by g · nsteps), 1024 a tile; the inputs are 416 KB
    g9, steps9 = 32, 2048
    loop, wide, x, oracle = pr.p9_arrays(g9)
    xd = torch.from_numpy(x).to(dev)
    split = pr.gather_split(g9, steps9, nsm)
    ops = g9 * steps9 * 1024
    err = 0.0
    for form, w, arrs in (("loop", False, loop), ("wide", True,
                                                  wide + (None,))):
        a0, a1, a2 = (None if v is None else torch.from_numpy(v).to(dev)
                      for v in arrs)
        absref = pr.window_gather_plain(w, a0, a1, a2, xd.abs())
        y = pr.window_gather(w, a0, a1, a2, xd, steps9)
        err = max(err, _held(f"window_gather {form}", y,
                             pr.window_gather_plain(w, a0, a1, a2, xd),
                             absref, BOUND))
        _held(f"window_gather {form} (oracle)", y,
              torch.from_numpy(oracle), absref, BOUND)
        fn = (lambda v, w=w, a0=a0, a1=a1, a2=a2:  # noqa: E731
              pr.window_gather(w, a0, a1, a2, v, steps9))
        repeats_its_y(f"window_gather {form}", fn, xd)
        if not np.array_equal(y.cpu().numpy(), pr.window_gather_order(
                w, *arrs, x, split)):
            raise AssertionError(f"window_gather {form}: not its order's "
                                 "numpy statement bit for bit")
        nbytes = sum(v.nbytes for v in arrs if v is not None) + x.nbytes \
            + 4096
        bound, by = _bound_ms(nbytes, ops)
        warm = profile_calls(fn, xd)
        cold = profile_calls(fn, xd, cold=True)
        rec = dict(
            ms=cuda_ms(fn, xd), device_ms=warm["device_ms"],
            device_ms_spread=warm.get("device_ms_spread"),
            cold_ms=cuda_ms(fn, xd, cold=True),
            cold_device_ms=cold["device_ms"],
            cold_device_ms_spread=cold.get("device_ms_spread"),
            plain_ms=cuda_ms(lambda v, w=w, a0=a0, a1=a1, a2=a2:
                             pr.window_gather_plain(w, a0, a1, a2, v), xd),
            bound_ms=bound, bound_by=by, bytes=nbytes)
        log(json.dumps({"phase": "prices", "sweep": "window_gather",
                        "form": form, "g": g9, "nsteps": steps9,
                        "chunks": len(split.chunks), **rec,
                        "ns_tile_warm": _per(rec["device_ms"],
                                             g9 * steps9),
                        "ns_tile_cold": _per(rec["cold_device_ms"],
                                             g9 * steps9),
                        "bound_share_warm": (
                            bound / rec["device_ms"]
                            if isinstance(rec["device_ms"], float)
                            else "not measured")}))
        if form == "loop":
            recs["window_gather"] = dict(
                rec, library_ms=None, library_call=None,
                family=f"P9 loop, g {g9}, {steps9} steps")
    recs["window_gather"]["max_abs_err"] = err

    # tiny and fma_err, bit for bit; tiny's chains of 100 launches from C
    # (with and without PDL) bit for bit v·2^100 over CHAIN_CHECKS chains
    # each: a wait placed after the load would read a predecessor's output
    # early, and with an 8 KB tile such a race may show rarely.  One call
    # (events), device time (profiler), the host's µs a call, and each
    # chain's ms a launch (probes.chain_ms)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)
                         ).to(dev)
    err = _held("tiny", pr.tiny(v), pr.tiny_plain(v), None, None,
                exact=True)
    n = pr.CHAIN_LAUNCHES
    want = pr.tiny_chain_plain(v, n)
    for pdl in (False, True):
        for i in range(CHAIN_CHECKS):
            err = max(err, _held(f"tiny_chain (pdl {pdl}, chain {i})",
                                 pr.tiny_chain(v, n, pdl), want, None, None,
                                 exact=True))
    chain, chain_pdl = pr.chain_ms(v, False), pr.chain_ms(v, True)
    recs["tiny"] = dict(
        max_abs_err=err, ms=cuda_ms(pr.tiny, v),
        device_ms=profile_calls(pr.tiny, v)["device_ms"],
        host_us=timing.host_us(pr.tiny, v), chain_ms=chain["ms"],
        chain_pdl_ms=chain_pdl["ms"], chain_host_us=chain["host_us"],
        chain_pdl_host_us=chain_pdl["host_us"], chain_checks=CHAIN_CHECKS,
        plain_ms=cuda_ms(pr.tiny_plain, v),
        library_ms=cuda_ms(lambda t: torch.mul(t, 2.0), v),
        library_call="torch.mul(v, 2.0)", bytes=8192, family="P6 tile",
        **dict(zip(("bound_ms", "bound_by"), _bound_ms(8192, 1024))))
    a8, b8 = (torch.from_numpy(rng.standard_normal((8, 128)).astype(
        np.float32)).to(dev) for _ in range(2))
    p8 = a8 * b8
    fma = lambda t: pr.fma_err(t, b8, p8)  # noqa: E731
    recs["fma_err"] = dict(
        max_abs_err=_held("fma_err", fma(a8), pr.fma_err_plain(a8, b8, p8),
                          None, None, exact=True),
        ms=cuda_ms(fma, a8), device_ms=profile_calls(fma, a8)["device_ms"],
        host_us=timing.host_us(fma, a8),
        plain_ms=cuda_ms(lambda t: pr.fma_err_plain(t, b8, p8), a8),
        library_ms=None, library_call=None, bytes=16384, family="P8 tile",
        **dict(zip(("bound_ms", "bound_by"), _bound_ms(16384, 2048))))
    return recs


def _rest_nnz(plan):
    """Nonzeros of every straggler stream in a placed plan."""
    if isinstance(plan, dict):
        own = int(plan["rest"]["cols"].numel()) if "rest" in plan else 0
        return own + sum(_rest_nnz(v) for k, v in plan.items()
                         if k != "rest")
    if isinstance(plan, (tuple, list)):
        return sum(_rest_nnz(v) for v in plan)
    return 0


def route_of(h):
    """A plan's route: its kind and value mode, each stream's kernel, nw,
    g and tiles, and its straggler nonzeros."""
    from spmv_tpu_torch.handle import plan_kind
    parts = [plan_kind(h.plan), str(h.plan.get("value_mode"))]
    for st, _cols in family_streams(h.plan):
        if is_dia(st) or is_coo2(st) or is_cs(st):
            parts.append(kernel_of(st))
        else:
            parts.append(f"{kernel_of(st)}:nw{st.nw}:g{st.g}:"
                         f"t{st.meta.shape[0]}")
    parts.append(f"rest{_rest_nnz(h.plan)}")
    return " ".join(parts)


def prices_calibration(dev, kern, mats):
    """The probes (one counted run: each probe kernel must launch), each
    probe kernel against its plain version, the calibration's figures and
    the table derived from them, printed beside ``H100`` and
    ``REFERENCE`` with the drift from ``H100``.  Returns (the derived
    table, the figures, the probe kernels' launches)."""
    import dataclasses as dc
    from spmv_tpu_torch.bench import probes as pr
    from spmv_tpu_torch.formats import prices as pm
    from spmv_tpu_torch.utils.profiling import launches
    for k in pr.KERNELS:
        launches[k] = 0
    runs = pr.run_probes(mats, dev)
    counts = {k: launches[k] for k in pr.KERNELS}
    log(json.dumps({"phase": "main_path_launches", "path": "prices",
                    **counts}))
    for k, c in counts.items():
        if c == 0:
            raise AssertionError(f"prices: probe kernel {k} was not "
                                 "launched")
    for probe, recs in runs.items():
        for rec in recs if isinstance(recs, list) else [recs]:
            log(json.dumps({"phase": "prices", "probe": probe, **rec}))
    for name, rec in probe_kernel_records(dev, mats).items():
        kern[name].update(rec)
        log(json.dumps({"phase": "prices", "kernel": name, **rec}))
    cal = pr.calibrate(mats, dev, runs)
    log(json.dumps({"phase": "prices", "figures": cal["figures"],
                    "detail": cal["detail"]}))
    derived = pm.derive_prices(cal["figures"])
    table = {}
    for f in dc.fields(pm.Prices):
        d, h, r = (getattr(t, f.name) for t in (derived, pm.H100,
                                                pm.REFERENCE))
        dd, hh = (d, h) if isinstance(d, tuple) else ((d,), (h,))
        table[f.name] = {"derived": d, "H100": h, "REFERENCE": r,
                         "drift": [(u - v) / v if v else None
                                   for u, v in zip(dd, hh)]}
    log(json.dumps({"phase": "prices", "table": table}))
    return derived, cal["figures"], counts


def prices_routes(dev, ctx, table, names=PRICE_FAMILIES, label="h100"):
    """Each family of ``names`` planned under ``table`` beside its
    REFERENCE plan from the main path (``ctx``); where the routes differ,
    both plans' y against the family's reference and bound, and both timed
    in turns (reference, table, table, reference: CUDA events, median of
    30) with a profile each.  ``label`` names the table in the rows."""
    import gc
    import spmv_tpu_torch as st
    import torch
    from spmv_tpu_torch.handle import plan_kind
    rows = []
    for name in names:
        h_ref, a, x, ref, absref, bound = ctx[name]
        t0 = time.perf_counter()
        h = st.create_handle(a, method=st.Method.AUTO, device=dev,
                             prices=table)
        plan_s = time.perf_counter() - t0
        repeats_its_y(f"prices {name} ({label})", h, x)
        r_ref, r_new = route_of(h_ref), route_of(h)
        row = {"phase": "prices", "family": name, "route_reference": r_ref,
               f"route_{label}": r_new, "differs": r_ref != r_new,
               "plan_s": plan_s}
        if r_ref != r_new:
            for tag, hh in (("reference", h_ref), (label, h)):
                y = hh(x)
                # a scan plan's bound has its absolute term
                rel, mabs, ok = scaled_err(y.cpu(), ref, absref, bound,
                                           scan_atol(hh, a, ref))
                if not ok:
                    raise AssertionError(f"prices {name}: the {tag} plan's "
                                         f"max scaled error {rel:.3g}")
                row[f"{tag}_scaled_err"] = rel
            ms_ref = [cuda_ms(h_ref, x)]
            ms_new = [cuda_ms(h, x), cuda_ms(h, x)]
            ms_ref.append(cuda_ms(h_ref, x))
            row.update({"ms_reference": ms_ref, f"ms_{label}": ms_new,
                        "device_ms_reference":
                        profile_calls(h_ref, x)["device_ms"],
                        f"device_ms_{label}":
                        profile_calls(h, x)["device_ms"]})
        if plan_kind(h.plan) in SCAN_KINDS:
            raise AssertionError(f"prices {name}: the {label} table leaves "
                                 "AUTO the tiled scan")
        log(json.dumps(row))
        rows.append(row)
        del h
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def prices_phase(dev, kern, ctx):
    """The planner's calibration: :func:`prices_calibration` on the main
    path's matrices, then :func:`prices_routes` under the committed
    ``H100`` table, and on :data:`CHEAP_FAMILIES` under this run's table
    with the straggler priced on the long stream (a tenth of a tile or
    less: the depth cap must keep each route within its spill gate).
    Returns the probe kernels' launches."""
    from spmv_tpu_torch.bench.probes import row_slice
    from spmv_tpu_torch.formats.prices import H100
    t0 = time.perf_counter()
    mats = {"clustered": ctx["clustered200k"][1],
            "clustered_f64": ctx["clustered200k_f64"][1],
            "uniform": ctx["uniform100k"][1],
            "uniform_f64": ctx["uniform100k_f64"][1],
            "webbase": ctx["webbase1m"][1],
            "wide": row_slice(ctx["clustered2500k_s64"][1], WIDE_ROWS)}
    derived, figures, counts = prices_calibration(dev, kern, mats)
    prices_routes(dev, ctx, H100)
    long_ns = figures["rest_ns_long"]
    prices_routes(dev, ctx, dataclasses.replace(derived, spill_ns=long_ns,
                                                pair_spill_ns=long_ns),
                  CHEAP_FAMILIES, "cheap_stragglers")
    log(json.dumps({"phase": "prices", "seconds":
                    time.perf_counter() - t0}))
    return counts


def folds_phase(dev, gpu, a):
    """The two folds of repeated rows (``torch_csr.fold_add``) on the card
    at powerlaw100k's size ``a``: the mega-row fold (``split_megarows``'s
    sub-rows of ``a``, each sub-row's sum folded into its origin row) and a
    mesh plan's straggler rows (``mesh._add_rest`` over every nonzero of
    the rows ``split_megarows`` cuts, shuffled), f32 and f64.  Each is
    called REPEAT_CALLS times from one y on one input, the ys bit for bit,
    and held to the CPU's ``index_add_`` in f64 within BOUND (f32) or
    BOUND_F64 (f64) of |y_i| plus its terms' magnitudes; its time beside
    the ``index_add_`` it replaced on the same input, and whether that
    repeated.  Logs ``{"phase": "folds", ...}`` lines."""
    import numpy as np
    import torch
    from spmv_tpu_torch.formats.sell8w import split_megarows
    from spmv_tpu_torch.ops import torch_csr
    from spmv_tpu_torch.parallel import mesh as pm
    a_ext, sub = split_megarows(a)
    if sub is None:
        raise AssertionError("folds: powerlaw100k has no mega-rows")
    m, rng = a.m, np.random.default_rng(11)
    xh, y0 = rng.standard_normal(a.n), rng.standard_normal(m)
    lo = int(a_ext.rowptr[m])
    prod = a_ext.vals[lo:].astype(np.float64) * xh[a_ext.colidx[lo:]]
    sub_sums = np.add.reduceat(prod, a_ext.rowptr[m:-1] - lo)
    row_of = np.repeat(np.arange(m), np.diff(a.rowptr))
    pick = rng.permutation(np.flatnonzero(np.isin(row_of, sub)))
    rows, cols = row_of[pick], a.colidx[pick].astype(np.int64)
    mesh = pm.make_mesh_1d(1, device=dev)
    for dt, bound in ((np.float32, BOUND), (np.float64, BOUND_F64)):
        tdt = torch.from_numpy(np.zeros(0, dt)).dtype
        yd = torch.from_numpy(y0.astype(dt)).to(dev)
        terms = sub_sums.astype(dt)
        vals = a.vals[pick].astype(dt)
        x = torch.from_numpy(xh.astype(dt)).to(dev)
        sub_t, rows_t = (torch.from_numpy(v).to(dev) for v in (sub, rows))
        cols_t, vals_t = (torch.from_numpy(v).to(dev) for v in (cols, vals))
        fold, rest = torch_csr.fold_plan(sub, dev), pm._place_rest(
            mesh, (rows, cols, vals))
        cases = {
            "mega_fold": (sub, terms, torch.from_numpy(terms).to(dev),
                          lambda t: torch_csr.fold_add(yd.clone(), fold, t),
                          lambda t: yd.clone().index_add_(0, sub_t, t)),
            "mesh_rest": (rows, vals.astype(np.float64)
                          * xh.astype(dt).astype(np.float64)[cols], x,
                          lambda v: pm._add_rest(yd.clone(), rest, v),
                          lambda v: yd.clone().index_add_(
                              0, rows_t, (vals_t * v[cols_t]).to(tdt)))}
        for fold_name, (ids, t64, inp, fn, old) in cases.items():
            name = f"folds {fold_name} {tdt}"
            y = fn(inp)
            repeats_its_y(name, fn, inp)
            ids_h = torch.from_numpy(ids)
            y0h = torch.from_numpy(y0.astype(dt).astype(np.float64))
            ref = y0h.clone().index_add_(0, ids_h, torch.from_numpy(
                np.asarray(t64, np.float64)))
            absref = y0h.abs().index_add_(0, ids_h, torch.from_numpy(
                np.abs(np.asarray(t64, np.float64))))
            rel, mabs, ok = scaled_err(y.cpu(), ref, absref, bound)
            if not ok:
                raise AssertionError(f"{name}: max scaled error {rel:.3g} "
                                     "against index_add_ in f64")
            y_old = old(inp)
            old_repeats = all(torch.equal(y_old, old(inp))
                              for _ in range(REPEAT_CALLS - 1))
            counts = np.bincount(ids)
            log(json.dumps({
                "phase": "folds", "fold": fold_name, "dtype": str(tdt),
                "gpu": gpu, "terms": len(ids),
                "rows": int((counts > 0).sum()),
                "most_terms_a_row": int(counts.max()),
                "max_scaled_err": rel, "max_abs_err": mabs,
                "ms": cuda_ms(fn, inp),
                "device_ms": profile_calls(fn, inp)["device_ms"],
                "index_add_ms": cuda_ms(old, inp),
                "index_add_device_ms": profile_calls(old, inp)["device_ms"],
                "index_add_repeats": old_repeats}))


#: the bench phase's time limit, seconds (the bench takes about a minute)
BENCH_TIMEOUT = 420


def bench_phase(gpu):
    """``python3 bench_torch.py``, the port's headline bench, as a process
    of its own on the card from this checkout, its pre-deal included.  Its
    last stdout line must parse and hold every family of the bench's
    ``REFS``, none with ``e`` and every ``g`` > 0.  Logs the line, each
    family's windows and their spread from the full record, and the
    phase's wall seconds; a bench that fails or passes BENCH_TIMEOUT fails
    the phase with its log's tail."""
    import torch
    from spmv_tpu_torch.bench import headline
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="bench_torch_") as out_dir:
        t0 = time.perf_counter()
        try:
            res = subprocess.run([sys.executable,
                                  os.path.join(ROOT, "bench_torch.py"),
                                  "--out-dir", out_dir], cwd=ROOT,
                                 capture_output=True, text=True,
                                 timeout=BENCH_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"bench_torch.py passed {BENCH_TIMEOUT} "
                                 f"s: {(e.stderr or b'')[-2000:]!r}"
                                 ) from None
        wall = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        try:
            rec = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            raise AssertionError(f"bench_torch.py exited {res.returncode} "
                                 "without a JSON last line: "
                                 f"{res.stderr[-2000:]}") from None
        fams = rec.get("families", {})
        bad = sorted(set(headline.REFS) - set(fams)) + sorted(
            n for n, f in fams.items() if "e" in f or not f.get("g", 0) > 0)
        log(json.dumps({"phase": "bench", "gpu": gpu, "line": rec,
                        "line_chars": len(lines[-1]), "rc": res.returncode,
                        "wall_s": wall}))
        if (res.returncode != 0 or bad
                or len(lines[-1]) >= headline.LINE_MAX):
            raise AssertionError(f"bench_torch.py: exit {res.returncode}, "
                                 "families missing, failed or not above 0 "
                                 f"GF/s: {bad}; {res.stderr[-2000:]}")
        with open(os.path.join(out_dir, headline.RECORD)) as f:
            full = json.load(f)
    for name, c in full["configs"].items():
        w = c["windows_ms"]
        log(json.dumps({"phase": "bench", "family": name, **{
            k: c[k] for k in ("gflops", "gflops_marginal", "ms",
                              "sync_bubble_ms", "method", "value_mode",
                              "predeal_ms", "pack_ms", "transfer_ms",
                              "vs_ref")},
            "windows_ms": w, "window_spread": max(w) / min(w) - 1}))


#: the SASS that griddepcontrol.wait and griddepcontrol.launch_dependents
#: lower to on sm_90a (nvcc 12.9, ``cuobjdump -sass``)
PDL_WAIT_SASS, PDL_TRIGGER_SASS = "ACQBULK", "PREEXIT"
#: the kernels that launch with programmatic dependent launch
PDL_KERNELS = ("tiny_kernel", "fma_err_kernel")
#: chains of ``probes.CHAIN_LAUNCHES`` launches held bit for bit, each way
CHAIN_CHECKS = 20

#: shared-memory loads window_gather's step loop issues an iteration: 4
#: tiles of 4 rows a thread, each slot's ridx, wsel, cell and x words in the
#: loop form, its srow, cell and x words in the wide form
GATHER_LOOP_LDS = {"loop": 64, "wide": 48}


def probe_sass(lib, nvcc):
    """The built ``probes`` library's SASS (``cuobjdump -sass``): each
    function's mangled name → its (address, instruction) pairs."""
    so = lib.libs["probes"]._name
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        out[fn.split("\n", 1)[0].strip()] = [
            (int(a, 16), t.strip()) for a, t in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    return out


def sass_op(text):
    """An instruction's opcode without its predicate and modifiers
    (``@!P0 LDG.E.128 R8, ...`` → ``LDG``)."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def pdl_sass(lib, nvcc):
    """``tiny`` and ``fma_err`` in the built SASS: each must carry the
    wait of programmatic dependent launch (:data:`PDL_WAIT_SASS`, what
    ``griddepcontrol.wait`` lowers to) before its first global load, and
    the trigger (:data:`PDL_TRIGGER_SASS`); logs a ``sass`` line each."""
    sass = probe_sass(lib, nvcc)
    for kernel in PDL_KERNELS:
        names = [n for n in sass if kernel in n]
        if len(names) != 1:
            raise AssertionError(f"sass: {len(names)} functions named "
                                 f"{kernel}")
        ins = sass[names[0]]
        ops = [(a, sass_op(t)) for a, t in ins]

        def first(op, ops=ops):
            return next((a for a, o in ops if o == op), None)
        rec = {"phase": "sass", "kernel": kernel.replace("_kernel", ""),
               "wait": PDL_WAIT_SASS, "wait_at": first(PDL_WAIT_SASS),
               "trigger": PDL_TRIGGER_SASS,
               "trigger_at": first(PDL_TRIGGER_SASS),
               "first_load_at": first("LDG"), "instructions": len(ins)}
        log(json.dumps(rec))
        if rec["wait_at"] is None or rec["trigger_at"] is None:
            raise AssertionError(f"sass: {kernel} has no {PDL_WAIT_SASS} "
                                 f"or {PDL_TRIGGER_SASS}: it was not built "
                                 "for programmatic dependent launch")
        if rec["first_load_at"] is None or \
                rec["first_load_at"] < rec["wait_at"]:
            raise AssertionError(f"sass: {kernel} loads before its "
                                 f"{PDL_WAIT_SASS} (griddepcontrol.wait)")


def gather_sass(lib, nvcc, ptxas):
    """window_gather's step loop in the built library's SASS (``cuobjdump
    -sass``; the loop is the backward branch whose body holds the most
    LDS), beside ptxas' registers and spills for each form; fails unless
    the loop issues every slot's shared-memory loads each step (they are
    volatile, so nvcc cannot hoist them out and fold the steps)."""
    rec = {"phase": "sass", "kernel": "window_gather"}
    for name, ins in probe_sass(lib, nvcc).items():
        if "window_gather_kernel" not in name:
            continue
        form = "wide" if "ILb1E" in name else "loop"
        best = {"lds": 0}
        for addr, text in ins:
            m = re.search(r"BRA (0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                lds = sum(1 for t in body if re.search(r"\bLDS\b", t))
                if lds > best["lds"]:
                    best = {"lds": lds, "fadd": sum(
                        1 for t in body if re.search(r"\bFADD\b", t)),
                        "instructions": len(body)}
        m = re.search(r"Compiling entry function '" + re.escape(name)
                      + r"'.*?Used (\d+) registers", ptxas, re.S)
        sp = re.search(r"Function properties for " + re.escape(name)
                       + r"\s+\d+ bytes stack frame, (\d+) bytes spill",
                       ptxas)
        rec[form] = dict(best, registers=int(m.group(1)) if m else None,
                         spill_bytes=int(sp.group(1)) if sp else None)
    log(json.dumps(rec))
    for form, want in GATHER_LOOP_LDS.items():
        if rec.get(form, {}).get("lds", 0) < want:
            raise AssertionError(f"window_gather ({form}): its step loop "
                                 f"issues {rec.get(form)} shared-memory "
                                 f"loads, not {want} each step")


#: the launch figures of ``tiny`` and ``fma_err`` the kernels line adds
LAUNCH_FIELDS = ("host_us", "chain_ms", "chain_pdl_ms", "chain_host_us",
                 "chain_pdl_host_us", "chain_checks")


def kernels_line(launches, kern):
    """The ``kernels`` line's entries, one a kernel."""
    kernels = []
    for name, (src, rep) in KERNELS.items():
        k = kern[name]
        # the probe kernels have no profile windows or padded stream
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"],
                        "library_call": k["library_call"],
                        "device_ms": k.get("device_ms"),
                        "device_ms_spread": k.get("device_ms_spread"),
                        "cold_ms": k.get("cold_ms"),
                        "cold_device_ms": k.get("cold_device_ms"),
                        "cold_device_ms_spread":
                        k.get("cold_device_ms_spread"),
                        "bytes": k["bytes"],
                        "stream_bound_ms": k.get("stream_bound_ms"),
                        "stream_bytes": k.get("stream_bytes"),
                        "family": k["family"],
                        **{f: k[f] for f in LAUNCH_FIELDS if f in k}})
        if name in ALSO_REPLACES:
            kernels[-1]["also_replaces"] = list(ALSO_REPLACES[name])
    return kernels


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "spmv_tpu_torch")):
        print("chip_smoke.py: no spmv_tpu_torch package beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    smi = _cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"])
    from spmv_tpu_torch import _build
    from spmv_tpu_torch.native import native_available
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    nvcc = _build.nvcc_path()
    log(json.dumps({"phase": "toolchain", "gpu": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvcc": _cmd_line([nvcc, "--version"]) if nvcc
                    else None, "triton": triton_v,
                    "python": sys.version.split()[0],
                    "numpy": np.__version__}))
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    if not native_available():
        raise RuntimeError("the native host packer did not build")
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = _build.load_kernels()
    t_cuda = time.perf_counter() - t0
    log(json.dumps({"phase": "build", "native_s": t_native,
                    "cuda_s": t_cuda, "libraries": sorted(
                        os.path.basename(p) for p in lib.logs)}))
    ptxas = ""
    for path in lib.logs:
        with open(path) as f:
            ptxas += f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill", ptxas)]
    log(json.dumps({"phase": "ptxas", "kernels": len(regs),
                    "registers_max": max(regs, default=0),
                    "spill_bytes": sum(spills)}))
    gather_sass(lib, nvcc, ptxas)
    pdl_sass(lib, nvcc)

    # the process's first profile window (the profiler starts CUPTI on
    # first use): what it saw, beside the first family's windows
    first, _w, seen = profile_window(lambda v: v * 2,
                                     torch.ones(1 << 20, device=dev), 4)
    log(json.dumps({"phase": "profiler", "first_window_kernels": len(first),
                    "events_without_kernels": seen}))
    kern = {k: {"max_abs_err": 0.0} for k in KERNELS}
    kernel_phase(dev, kern)
    cs_launches = sell_cs_phase(dev, kern)
    launches, ctx, pctx = main_path(dev, kern, smi)
    for k, c in cs_launches.items():
        launches[k] += c
    folds_phase(dev, smi, pctx["powerlaw100k"][1])
    for k, c in prices_phase(dev, kern, pctx).items():
        launches[k] += c
    del pctx
    windowed_phase(dev, kern, ctx)
    del ctx
    with tempfile.TemporaryDirectory() as work:
        for k, c in dist_phase(dev, kern, work).items():
            launches[k] += c
        # the dist plans are gone: hand their blocks back, so that the
        # two rank processes fit on the card beside this one
        gc.collect()
        torch.cuda.empty_cache()
        for k, c in multihost_phase(work).items():
            launches[k] += c
    for k, c in tools_phase(dev, smi).items():
        launches[k] += c
    bench_phase(smi)
    kernels = kernels_line(launches, kern)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"phase": "wall", "seconds":
                    time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--multihost-rank"]:
            rc = multihost_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        else:
            rc = main()
    except Exception:  # noqa: BLE001 — report the failed phase, no "ok"
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
