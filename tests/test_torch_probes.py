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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
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


@pytest.mark.parametrize("n", [1, 2, 99, 100])
def test_tiny_chain_plain_is_v_times_two_to_the_n(n):
    # the chain's plain version, n applications of tiny: v·2ⁿ bit for bit
    # (a power of two times a normal f32 is exact while it stays finite)
    v = np.random.default_rng(8).standard_normal((8, 128)).astype(np.float32)
    got = pr.tiny_chain_plain(torch.from_numpy(v), n).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, v * np.float32(2.0 ** n))


def test_tiny_chain_plain_matches_tiny_kern_applied_twice():
    # probe5_floor.py builds tiny_kern inside main(): rebuilt here as it is
    # written there, run in interpret mode, applied n = 2 times
    def tiny_kern(v_ref, o_ref):
        o_ref[:] = v_ref[:] * 2.0

    tiny_pallas = jax.jit(pl.pallas_call(
        tiny_kern, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True))
    v = np.random.default_rng(9).standard_normal((8, 128)).astype(np.float32)
    want = np.asarray(tiny_pallas(tiny_pallas(jnp.asarray(v))))
    got = pr.tiny_chain_plain(torch.from_numpy(v), 2)
    assert np.array_equal(got.numpy(), want)
    # on a CPU tensor the chain's wrapper runs its plain version
    assert np.array_equal(pr.tiny_chain(torch.from_numpy(v), 2).numpy(),
                          want)


def test_probe_tiny_reports_the_eager_and_chained_figures():
    # the plain loop's times on the CPU, under the card's field names
    rec = pr.probe_tiny("cpu", iters=3)
    for k in ("tiny_pallas_ms", "tiny_chain_ms", "tiny_chain_pdl_ms",
              "tiny_host_us", "tiny_chain_host_us",
              "tiny_chain_pdl_host_us"):
        assert isinstance(rec[k], float) and rec[k] > 0, k
    assert len(rec["all_ms"]) == 3


def test_wrappers_raise_off_the_cpu_without_cuda():
    # a tensor neither on the CPU nor on a CUDA device: no fallback
    meta_dev = torch.empty(4, 8, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pr.tile_stream(meta_dev, 1, True, torch.empty(8, 128, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        pr.tiny(torch.empty(8, 128, device="meta"))


def test_chain_and_fma_err_raise_off_the_cpu_without_cuda():
    # tiny_chain and fma_err, like tiny: no kernel for a meta tensor
    with pytest.raises(ValueError, match="no kernel"):
        pr.tiny_chain(torch.empty(8, 128, device="meta"), 3)
    with pytest.raises(ValueError, match="no kernel"):
        pr.fma_err(*(torch.empty(8, 128, device="meta") for _ in range(3)))


@pytest.fixture(scope="module")
def calibrated():
    """(mats, run_probes' records, calibrate's result) at a small size on
    the plain versions."""
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
    return mats, runs, pr.calibrate(mats, "cpu", runs)


def test_calibrate_takes_launch_ns_from_the_eager_chain(calibrated):
    # launch_ns stays the eager figure (a stripe pays an eager call), not
    # the chain's: P6's figures made distinct, the table's launch is the
    # eager one's
    mats, runs, _cal = calibrated
    p6 = dict(runs["P6"], tiny_pallas_ms=0.0125, tiny_chain_ms=0.0025,
              tiny_chain_pdl_ms=0.0015)
    fig = pr.calibrate(mats, "cpu", dict(runs, P6=p6))["figures"]
    assert fig["launch_ns"] == 0.0125 * 1e6
    assert pm.derive_prices(fig).stripe_call_ns == 0.0125 * 1e6


def test_run_probes_and_calibrate_on_the_cpu(calibrated):
    # every probe under its JAX field names, and every figure that
    # derive_prices reads, at a small size on the plain versions
    mats, runs, cal = calibrated
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
    fig = cal["figures"]
    assert cal["detail"]["slot_w"][8]["kernel"] == "sell_slot_w"
    assert cal["detail"]["slot_df16"][4]["value_mode"] == "df16"
    assert cal["detail"]["row_df"]["value_mode"] == "df"
    assert fig["rest_nnz"] > 0
    assert isinstance(pm.derive_prices(fig), pm.Prices)


def test_probes_module_counts_only_kernel_launches():
    # on the CPU the wrappers run their plain versions and count nothing in
    # the launch table; a launch counts under its kernel's name
    from spmv_tpu_torch.utils.profiling import launches
    before = {k: launches[k] for k in pr.KERNELS}
    pr.tiny(torch.ones(8, 128))
    pr.tiny_chain(torch.ones(8, 128), 5)
    pr.fma_err(torch.ones(4), torch.ones(4), torch.ones(4))
    assert before == {k: launches[k] for k in pr.KERNELS}
    pr._count("tiny", 5)
    assert launches["tiny"] == before["tiny"] + 5
    launches["tiny"] -= 5


# -- the kernels' split tables and reduce order (csrc/probes.cu) -------------

@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("block", [1, 8, 64, 512])
@pytest.mark.parametrize("nsm", [3, 132])
def test_stream_split_covers_every_tile_once_in_order(block, accumulate,
                                                      nsm):
    # 1100 tiles leave a ragged tail at every B but 1: the chunks cover
    # [0, nsteps·B) in order, whole steps where a step is not cut, and
    # every cut output's slots reach one node tree
    nsteps = 1100 // block
    sp = pr.stream_split(nsteps, block, accumulate, nsm)
    lo, hi, slot, out = sp.chunks.T.astype(np.int64)
    assert lo[0] == 0 and hi[-1] == nsteps * block
    assert np.array_equal(lo[1:], hi[:-1]) and np.all(hi > lo)
    assert len(lo) <= max(nsm * pr.STREAM_CHUNKS_PER_SM, 1) * 2
    cut = slot >= 0
    assert np.array_equal(np.sort(slot[cut]), np.arange(sp.nslots))
    if accumulate:
        assert np.all(out == 0) and (sp.nslots in (0, len(lo)))
    else:
        whole = ~cut
        assert np.all(lo[whole] % block == 0) and np.all(hi[whole] % block
                                                         == 0)
        assert np.array_equal(out[cut], lo[cut] // block)
        assert np.all((hi[cut] - 1) // block == lo[cut] // block)
    k = sp.slot_out[slot[cut]]
    assert np.all(np.diff(k) >= 0)
    counts = np.diff(sp.slot_ptr)
    assert np.all(counts >= 2) and np.array_equal(
        np.diff(sp.node_ptr), -(-counts // pr.REDUCE_FAN))


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("block", [1, 8, 64, 512])
def test_stream_order_statement_matches_the_plain_sum(block, accumulate):
    # the kernel's order (chunks, slots, nodes of 16), stated in numpy f32,
    # against tile_stream_plain within f32 rounding: 1e-6 of the sum of
    # magnitudes for a few thousand adds
    rng = np.random.default_rng(10 + block)
    vals = rng.standard_normal((1100, 8, 128)).astype(np.float32)
    c = rng.standard_normal((8, 128)).astype(np.float32)
    for nsm in (3, 132):
        sp = pr.stream_split(1100 // block, block, accumulate, nsm)
        got = pr.tile_stream_order(vals, block, accumulate, c, sp)
        want = pr.tile_stream_plain(torch.from_numpy(vals), block,
                                    accumulate, torch.from_numpy(c))
        scale = pr.tile_stream_plain(torch.from_numpy(np.abs(vals)), block,
                                     accumulate, torch.from_numpy(np.abs(c)))
        assert got.shape == tuple(want.shape)
        assert np.all(np.abs(got - want.numpy()) <= 1e-6 * scale.numpy())


def _body_walk(b, init, sp):
    """tile_body's kernel stated in numpy f64 over ``sp``: each chunk walks
    its tiles, adds init where a tile opens a step marked first, and ends
    each run in its group or its slot; the slots of a cut group summed
    node by node.  Returns (out, inits a group)."""
    rows = pr._body_rows(b).double().numpy().reshape(b.ntiles, -1)
    gi = b.ginfo.numpy().astype(np.int64)
    iv = init.double().numpy().reshape(-1)
    out = np.full((b.ngroups, rows.shape[1]), np.nan)
    part = np.zeros((sp.nslots, rows.shape[1]))
    inits = np.zeros(b.ngroups, np.int64)
    dest = {}
    for lo, hi, r0, r1 in sp.chunks.tolist():
        run, acc = r0, np.zeros(rows.shape[1])
        for t in range(lo, hi):
            if t % b.g == 0 and gi[t // b.g] & 1:
                acc += iv
                inits[gi[t // b.g] >> 1] += 1
            acc += rows[t]
            end, grp, slot, _ = sp.runs[run]
            assert grp == gi[t // b.g] >> 1
            if t + 1 == end:
                if slot < 0:
                    assert np.isnan(out[grp]).all()
                    out[grp] = acc
                else:
                    part[slot] = acc
                    dest[int(sp.slot_out[slot])] = grp
                run, acc = run + 1, np.zeros(rows.shape[1])
        assert run == r1
    for k, grp in dest.items():
        s0, s1 = sp.slot_ptr[k], sp.slot_ptr[k + 1]
        out[grp] = sum(part[a:min(a + pr.REDUCE_FAN, s1)].sum(0)
                       for a in range(s0, s1, pr.REDUCE_FAN))
    out[sp.zero_groups] = 0.0
    return out.reshape(b.ngroups, 8, 128), inits


@pytest.mark.parametrize("G", [8, 16, 64])
@pytest.mark.parametrize("nsm", [1, 3, 132])
def test_body_split_gives_each_group_its_init_once(packs, G, nsm):
    # fake monotone groups cut across chunk boundaries (and, at nsm 132,
    # short chunks that cut one group into many slots): each group gets
    # init once, every group is written once or zero-filled, and the walk
    # matches tile_body_plain
    _a, _packed, v2, _jp, _jv2 = packs
    b, _x = _random_x(pr.body_stream(v2, "full", G, "cpu"))
    init = torch.from_numpy(np.random.default_rng(G).standard_normal(
        (8, 128)).astype(np.float32))
    sp = pr.body_split(b.ginfo.numpy(), G, b.ngroups, nsm)
    lo, hi = sp.chunks[:, 0], sp.chunks[:, 1]
    assert lo[0] == 0 and hi[-1] == b.ntiles and np.array_equal(lo[1:],
                                                               hi[:-1])
    assert np.array_equal(sp.chunks[1:, 2], sp.chunks[:-1, 3])
    cut = sp.runs[:, 2] >= 0
    assert cut.sum() == sp.nslots and (nsm == 1 or sp.nslots > 0)
    got, inits = _body_walk(b, init, sp)
    first = pr._fake_ginfo(b.ginfo.numel(), b.ngroups)
    want_inits = np.bincount(first[first & 1 == 1] >> 1,
                             minlength=b.ngroups)
    assert np.array_equal(inits, want_inits) and inits.max() == 1
    babs = dataclasses.replace(b, palette=b.palette.abs(), x=b.x.abs())
    _close(got, pr.tile_body_plain(b, init).numpy(),
           pr.tile_body_plain(babs, init.abs()).numpy())


def test_body_split_one_group_over_many_chunks(packs):
    # P2's stream is one output block: at 132 SMs its pieces outnumber a
    # node, so the reduce takes two levels; init once
    _a, packed, _v2, _jp, _jv2 = packs
    b, _x = _random_x(pr.g8_stream(packed, "cpu"))
    init = torch.ones(8, 128)
    sp = pr.body_split(b.ginfo.numpy(), b.g, b.ngroups, 132)
    assert sp.nslots == len(sp.chunks) > pr.REDUCE_FAN
    assert sp.nnodes == -(-sp.nslots // pr.REDUCE_FAN)
    got, inits = _body_walk(b, init, sp)
    assert inits.tolist() == [1]
    babs = dataclasses.replace(b, vals=b.vals.abs(), x=b.x.abs())
    _close(got, pr.tile_body_plain(b, init).numpy(),
           pr.tile_body_plain(babs, init).numpy())


def test_body_split_group_visited_twice_goes_through_slots():
    # a group whose steps are not consecutive: both its runs become slots
    # (a direct write would drop the first), init from each first step
    ginfo = np.array([0 << 1 | 1, 1 << 1 | 1, 0 << 1 | 1, 3 << 1 | 1],
                     np.int32)
    sp = pr.body_split(ginfo, 2, 5, 1)       # a chunk a step
    slots = sp.runs[sp.runs[:, 2] >= 0]
    assert sorted(slots[:, 1].tolist()) == [0, 0]
    assert sp.zero_groups.tolist() == [2, 4]
    with pytest.raises(ValueError, match="outside ngroups"):
        pr.body_split(ginfo, 2, 3, 1)


def test_split_tables_are_made_anew_for_a_ginfo_written_in_place():
    # tile_body keys its tables by ginfo's id and stamps them with its
    # pointer and version counter: a write in place must not leave the
    # old split in use
    ginfo = torch.from_numpy(pr._fake_ginfo(6, 3))
    made = []

    def make():
        made.append(ginfo.clone())
        return pr.body_split(ginfo.numpy(), 2, 4, 1), torch.device("cpu")

    def tables():
        return pr._on_device(("body test", id(ginfo)), ginfo, make,
                             stamp=(ginfo.data_ptr(), ginfo._version))

    first = tables()
    assert tables() is first and len(made) == 1
    ginfo[2] = 3 << 1 | 1
    again = tables()
    assert again is not first and len(made) == 2
    assert again.split.zero_groups.tolist() == []
    assert first.split.zero_groups.tolist() == [3]
    assert tables() is again
    assert not again.tickets.any()


# -- window_gather's split and summation order (P9) --------------------------

@pytest.mark.parametrize("g", [4, 5, 7, 32])
@pytest.mark.parametrize("nsteps", [2, 7, 2048])
@pytest.mark.parametrize("nsm", [3, 7, 132])
def test_gather_split_covers_every_step_tile_pair_once(g, nsteps, nsm):
    # the grid's chunks cover every (step, tile) gather exactly once,
    # also where g's groups do not divide the grid (g 5 and 7; g 32 on 7
    # SMs: 8 groups, 14 chunks wanted); each chunk holds 1 to GATHER_TILES
    # tiles, and each group's sum is written once, by its chunk of step 0
    sp = pr.gather_split(g, nsteps, nsm)
    lo, hi, s0, s1 = sp.chunks.T.astype(np.int64)
    assert np.all(hi > lo) and np.all(hi - lo <= pr.GATHER_TILES)
    assert np.all(s1 > s0)
    seen = np.zeros((nsteps, g), np.int64)
    for a, b, c, d in zip(lo, hi, s0, s1):
        seen[c:d, a:b] += 1
    assert np.all(seen == 1)
    groups = sorted(set(zip(lo.tolist(), hi.tolist())))
    assert groups[0][0] == 0 and groups[-1][1] == g
    assert all(groups[k][1] == groups[k + 1][0]
               for k in range(len(groups) - 1))
    writers = sp.writes >= -1
    assert np.array_equal(writers, s0 == 0)
    if len(groups) == 1:
        assert sp.nslots == 0 and np.all(sp.writes[writers] == -1)
    else:
        # the slots are the groups in tile order, one split output
        assert np.array_equal(lo[writers][sp.writes[writers]],
                              [a for a, _b in groups])
        assert sp.slot_ptr.tolist() == [0, len(groups)]
        assert np.all(sp.slot_out == 0)
        assert np.diff(sp.node_ptr).tolist() == [
            -(-len(groups) // pr.REDUCE_FAN)]
    want = max(nsm * pr.GATHER_BLOCKS_PER_SM, len(groups))
    assert len(lo) == len(groups) * min(nsteps, -(-want // len(groups)))


def test_gather_split_rejects_no_work():
    for g, nsteps in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            pr.gather_split(g, nsteps, 132)


@pytest.mark.parametrize("g", [4, 7, 32, 80])
@pytest.mark.parametrize("kind", ["loop", "wide"])
def test_gather_order_statement_matches_the_plain_sum(g, kind):
    # the kernel's order (tiles of a group, then groups by nodes of 16; g
    # 80 has 20 groups, so two nodes), stated in numpy f32, against
    # window_gather_plain within f32 rounding
    (s, r, w), (cin, srow), x, oracle = pr.p9_arrays(g, seed=g)
    args = ((True, cin, srow, None) if kind == "wide"
            else (False, s, r, w))
    targs = [args[0]] + [None if a is None else torch.from_numpy(a)
                         for a in args[1:]]
    want = pr.window_gather_plain(*targs, torch.from_numpy(x)).numpy()
    scale = pr.window_gather_plain(*targs,
                                   torch.from_numpy(np.abs(x))).numpy()
    for nsm in (3, 132):
        got = pr.window_gather_order(*args, x, pr.gather_split(g, 2048,
                                                               nsm))
        assert got.dtype == np.float32 and got.shape == (8, 128)
        assert np.all(np.abs(got - want) <= 1e-6 * scale)
        assert np.all(np.abs(got - oracle) <= 1e-6 * scale)
