"""The calibration probes of ``spmv_tpu_torch/bench/probes.py`` against the
JAX package's probes in ``baselines/`` (P1-P9), on the CPU at a small size.

Each probe kernel's plain version is held to the JAX probe run in Pallas
interpret mode where the probe can run here and returns its kernel's
output: P1 (``make_stream_fn`` under ``force_tpu_interpret_mode``), P5
(``probe4_body.build``, same), P9 (``run(..., interpret=True)``).  The
others are held to a numpy statement of the probe's docstring, each for
the reason its test names: P3 (``pallas_huge``) and P4 (``v2_proto``) and P7
(``tile_stream_time``) return only a time; P6 (``tiny_pallas``) and P8
(``probe_fma``) build their kernel inline or only on a TPU; P2
(``make_g8_fn``) fails its BlockSpec check on this jax (its in_specs are x,
meta, vals, c and its arguments meta, vals, x, c).  The probes are imported
by path; ``baselines/`` is not edited.

Tolerances: f32 sums in another order, 1e-5 of the sum of magnitudes;
``tiny`` and ``fma_err`` exact.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spmv_tpu.formats.sell8w import pack_sell8w as j_pack_sell8w
from spmv_tpu.formats.sell8w import plan_v2 as j_plan_v2
from spmv_tpu.io import generate as j_gen
from spmv_tpu_torch.bench import probes as pr
from spmv_tpu_torch.formats import _bf16
from spmv_tpu_torch.formats import prices as pm
from spmv_tpu_torch.io import generate as t_gen
from spmv_tpu_torch.types import CsrMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        f"_baseline_{name}", os.path.join(ROOT, "baselines", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clustered(gen):
    """The probes' clustered matrix at a small size."""
    return gen.clustered(4000, 4000, 16, spread=256, dtype=np.float32,
                         seed=9)


@pytest.fixture(scope="module")
def packs():
    """(port matrix, port pack_sell8w, port plan_v2, JAX pack_sell8w, JAX
    plan_v2), as the probes make them."""
    a, packed, v2 = pr.probe_inputs(_clustered(t_gen))
    jp = j_pack_sell8w(_clustered(j_gen), max_pad_ratio=3.0)
    jv2 = j_plan_v2(jp, g=16)
    if jv2.palette is None:
        jv2 = dataclasses.replace(jv2, palette=np.zeros(128, np.float32))
    return a, packed, v2, jp, jv2


def _close(got, want, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL * np.asarray(scale) + 1e-30), \
        float(np.abs(got - want).max())


def test_packs_match_the_jax_probes_inputs(packs):
    _a, packed, v2, jp, jv2 = packs
    for f in ("meta", "vals", "window_ids", "slice_ids"):
        assert np.array_equal(getattr(packed, f), getattr(jp, f)), f
    for f in ("meta", "tinfo", "ginfo", "palette"):
        assert np.array_equal(getattr(v2, f), getattr(jv2, f)), f


# -- tile_stream: P1 (interpret mode), P3 and P7 (numpy) ----------------------

@pytest.mark.parametrize("block,accumulate", [(64, True), (1, True),
                                              (8, True), (8, False)])
def test_tile_stream_matches_make_stream_fn(packs, block, accumulate):
    # P1: make_stream_fn's step returns out[0] * 1e-3
    _a, packed, _v2, jp, _jv2 = packs
    p2 = _probe("probe2_stream")
    c = np.random.default_rng(1).standard_normal((8, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        step, nt = p2.make_stream_fn(jnp.asarray(jp.vals), block, accumulate)
        want = np.asarray(step(jnp.asarray(c)))
    vals = torch.from_numpy(packed.vals)
    out = pr.tile_stream(vals, block, accumulate, torch.from_numpy(c))
    got = out if accumulate else out[0]
    assert nt == vals.shape[0] // block * block
    summed = packed.vals[:nt] if accumulate else packed.vals[:block]
    scale = (np.abs(summed).sum(0) + np.abs(c)) * 1e-3
    _close(got.numpy() * 1e-3, want, scale)


@pytest.mark.parametrize("block", [512, 1, 8])
def test_tile_stream_numpy_statement(block):
    # P3 (pallas_huge, 512 tiles a step) and P7 (tile_stream_time, 1 and 8)
    # return only a time: the stream sum of their docstrings in numpy f64
    rng = np.random.default_rng(block)
    vals = rng.standard_normal((1100, 8, 128)).astype(np.float32)
    c = rng.standard_normal((8, 128)).astype(np.float32)
    nt = 1100 // block * block
    want = c.astype(np.float64) + vals[:nt].astype(np.float64).sum(0)
    got = pr.tile_stream(torch.from_numpy(vals), block, True,
                         torch.from_numpy(c))
    _close(got.numpy(), want, np.abs(vals[:nt]).sum(0) + np.abs(c))
    steps = pr.tile_stream(torch.from_numpy(vals), block, False,
                           torch.from_numpy(c))
    assert steps.shape == (nt // block, 8, 128)
    _close(steps.numpy()[-1], c + vals[nt - block:nt].astype(
        np.float64).sum(0), np.abs(vals[nt - block:nt]).sum(0) + np.abs(c))


# -- tile_body: P2, P4 (numpy), P5 (interpret mode) ---------------------------

def _body_numpy(meta, vals, tinfo, ginfo, x, init, G, ngroups, decode):
    """The row-mode body of probe2/3/4's kernels, step by step, with
    ``np.take_along_axis`` as the kernels take: window tinfo >> 3, row
    tinfo & 7, t1 = take(xwin, (m >> 7) & 7, axis=0), xg = take(t1, m & 127,
    axis=1), contrib = Σ_i value · xg into the row, init on a group's first
    step."""
    out = np.zeros((ngroups, 8, 128))
    x2 = np.asarray(x, np.float64).reshape(-1, 128)
    for p in range(len(ginfo)):
        gi = int(ginfo[p])
        if gi & 1:
            out[gi >> 1] += init
        for k in range(G):
            t = p * G + k
            ti = int(tinfo[t])
            m = meta[t].astype(np.int32)
            xwin = x2[(ti >> 3) * 8:(ti >> 3) * 8 + 8]
            t1 = np.take_along_axis(xwin, (m >> 7) & 7, axis=0)
            xg = np.take_along_axis(t1, m & 127, axis=1)
            v = decode(t, m) if vals is None else vals[t].astype(np.float64)
            out[gi >> 1, ti & 7] += (v * xg).sum(0)
    return out


def _random_x(b):
    x = np.random.default_rng(3).standard_normal(b.x.numel()).astype(
        np.float32)
    return dataclasses.replace(b, x=torch.from_numpy(x)), x


def test_tile_body_g8_numpy_statement(packs):
    # P2: make_g8_fn fails its BlockSpec check on this jax, so the body of
    # its docstring in numpy: 8 tiles a step, the step's window, row k & 7
    _a, packed, _v2, _jp, _jv2 = packs
    b, x = _random_x(pr.g8_stream(packed, "cpu"))
    init = np.random.default_rng(4).standard_normal((8, 128)).astype(
        np.float32)
    got = pr.tile_body(b, torch.from_numpy(init)).numpy()
    want = _body_numpy(b.meta.numpy(), b.vals.numpy(), b.tinfo.numpy(),
                       b.ginfo.numpy(), x, init, 8, 1, None)
    babs = dataclasses.replace(b, vals=b.vals.abs(), x=b.x.abs())
    scale = pr.tile_body_plain(babs, torch.from_numpy(np.abs(init))).numpy()
    _close(got, want, scale)


@pytest.mark.parametrize("mode", ["f32", "palette", "bf16"])
def test_tile_body_v2proto_numpy_statement(packs, mode):
    # P4: v2_proto returns only a time; its body in numpy (palette: the
    # dyadic code (m >> 10) & 7 times 1/8; bf16: the values rounded)
    _a, packed, _v2, _jp, _jv2 = packs
    b, x = _random_x(pr.v2proto_stream(packed, mode, "cpu"))
    assert b.g == 16 and b.ntiles == packed.ntiles // 16 * 16
    vals = None if b.vals is None else b.vals.float().numpy()
    if mode == "bf16":
        # jnp's astype(bfloat16): round to nearest even
        assert np.array_equal(vals, _bf16.to_f32(_bf16.from_f32(
            packed.vals[:b.ntiles])))
    init = np.ones((8, 128), np.float32)
    got = pr.tile_body(b, torch.from_numpy(init)).numpy()
    want = _body_numpy(b.meta.numpy(), vals, b.tinfo.numpy(),
                       b.ginfo.numpy(), x, init, 16, b.ngroups,
                       lambda t, m: ((m >> 10) & 7) * 0.125)
    babs = dataclasses.replace(b, x=b.x.abs(), vals=None if b.vals is None
                               else b.vals.abs())
    _close(got, want, pr.tile_body_plain(babs, torch.from_numpy(init)))


@pytest.mark.parametrize("variant,G", pr.BODY_VARIANTS)
def test_tile_body_matches_probe4_build(packs, variant, G):
    # P5: build's step returns out[0, 0] * 1e-3 over x of ones, each output
    # block zeroed on its first step
    _a, _packed, v2, _jp, jv2 = packs
    p4 = _probe("probe4_body")
    with pltpu.force_tpu_interpret_mode():
        step, nt = p4.build(jv2, variant, G)
        want = np.asarray(step(jnp.ones((128,), jnp.float32)))
    b = pr.body_stream(v2, variant, G, "cpu")
    assert b.ntiles == nt
    got = pr.tile_body(b, torch.zeros(8, 128)).numpy()[0, 0] * 1e-3
    babs = dataclasses.replace(b, palette=b.palette.abs())
    scale = pr.tile_body_plain(babs, torch.zeros(8, 128)).numpy()[0, 0]
    _close(got, want, scale * 1e-3)


# -- window_gather: P9 (interpret mode) ---------------------------------------

@pytest.mark.parametrize("kind", ["loop", "wide"])
def test_window_gather_matches_probe_wide_gather(kind):
    p9 = _probe("probe_wide_gather_r5")
    g = 4
    (s, r, w), (cin, srow), x, oracle = pr.p9_arrays(g)
    if kind == "loop":
        jargs = (jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                 jnp.asarray(x.reshape(64, 128)))
        targs = (False, torch.from_numpy(s), torch.from_numpy(r),
                 torch.from_numpy(w))
    else:
        jargs = (jnp.asarray(cin), jnp.asarray(srow),
                 jnp.asarray(x.reshape(8, 1024)))
        targs = (True, torch.from_numpy(cin), torch.from_numpy(srow), None)
    want = np.asarray(p9.run(kind, g, 2, jargs, interpret=True))[0]
    got = pr.window_gather(*targs, torch.from_numpy(x), 2).numpy()
    scale = pr.window_gather_plain(*targs,
                                   torch.from_numpy(np.abs(x))).numpy()
    _close(got, want, scale)
    _close(got, oracle, scale)


# -- tiny (P6) and fma_err (P8): numpy ----------------------------------------

def test_tiny_numpy_statement():
    # P6's tiny_pallas is built inside probe5_floor.main: one tile times 2
    v = np.random.default_rng(5).standard_normal((8, 128)).astype(np.float32)
    assert np.array_equal(pr.tiny(torch.from_numpy(v)).numpy(), v * 2)
    rec = pr.probe_tiny("cpu", iters=3)
    assert rec["tiny_pallas_ms"] > 0


def test_fma_err_numpy_statement():
    # P8's probe_fma runs only on a TPU: a·b − fl(a·b) is the product's
    # exact error, nonzero for most random pairs
    rec = pr.probe_fma("cpu")
    assert rec["fused_exact"] and not rec["all_zero"]
    rng = np.random.default_rng(6)
    a, b = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    p = a * b
    e = pr.fma_err(*(torch.from_numpy(v) for v in (a, b, p))).numpy()
    exact = a.astype(np.float64) * b.astype(np.float64) - p
    assert np.array_equal(e.astype(np.float64), exact)


def test_wrappers_raise_off_the_cpu_without_cuda():
    # a tensor neither on the CPU nor on a CUDA device: no fallback
    meta_dev = torch.empty(4, 8, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pr.tile_stream(meta_dev, 1, True, torch.empty(8, 128, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        pr.tiny(torch.empty(8, 128, device="meta"))


def test_run_probes_and_calibrate_on_the_cpu():
    # every probe under its JAX field names, and every figure that
    # derive_prices reads, at a small size on the plain versions
    def f64(a):
        return CsrMatrix(a.m, a.n, a.rowptr, a.colidx,
                         np.random.default_rng(7).standard_normal(a.nnz))
    cl = _clustered(t_gen)
    un = t_gen.random_uniform(3000, 3000, 20, dtype=np.float32, seed=42)
    wide = pr.row_slice(t_gen.clustered(2_100_000, 2_100_000, 2, spread=64,
                                        dtype=np.float32, seed=9), 3000)
    mats = {"clustered": cl, "clustered_f64": f64(cl), "uniform": un,
            "uniform_f64": f64(un), "wide": wide,
            "webbase": t_gen.webbase_like(20000, 20000, 60000,
                                          dtype=np.float32, seed=11)}
    runs = pr.run_probes(mats, "cpu")
    assert [r["variant"] for r in runs["P1"]] == ["S_big", "S_tile",
                                                  "S_tile8", "S_nodep"]
    assert {"variant", "ms", "equiv_gflops"} <= set(runs["P2"])
    assert runs["P3"]["variant"] == "B_huge512"
    assert [r["variant"] for r in runs["P4"]] == ["C_v2_f32", "C_v2_palette",
                                                  "C_v2_bf16"]
    assert [(r["variant"], r["G"]) for r in runs["P5"]] == list(
        pr.BODY_VARIANTS)
    assert "tiny_pallas_ms" in runs["P6"]
    assert [r["acc_block"] for r in runs["P7"]] == [1, 8]
    assert runs["P8"]["fused_exact"]
    assert all(r["max_err"] < 1e-4 for r in runs["P9"])
    cal = pr.calibrate(mats, "cpu", runs)
    fig = cal["figures"]
    assert cal["detail"]["slot_w"][8]["kernel"] == "sell_slot_w"
    assert cal["detail"]["slot_df16"][4]["value_mode"] == "df16"
    assert cal["detail"]["row_df"]["value_mode"] == "df"
    assert fig["rest_nnz"] > 0
    assert isinstance(pm.derive_prices(fig), pm.Prices)


def test_probes_module_counts_only_kernel_launches():
    # on the CPU the wrappers run their plain versions and count nothing
    before = {k: getattr(pr, a) for k, a in pr.KERNEL_COUNTS.items()}
    pr.tiny(torch.ones(8, 128))
    pr.fma_err(torch.ones(4), torch.ones(4), torch.ones(4))
    assert before == {k: getattr(pr, a) for k, a in pr.KERNEL_COUNTS.items()}
