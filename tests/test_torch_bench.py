"""The port's headline bench (``spmv_tpu_torch/bench/headline.py``, run as
``bench_torch.py``) on the CPU, at small sizes.

What the JAX package's ``tests/test_bench_record.py`` pins for ``bench.py``
holds here too: the compact last line stays under 1,900 characters,
survives a 2,000-character tail and parses with all nine families, and the
full record lands on disk with a failed family as ``{"e": 1}``.  Beyond
that: ``gen_one`` makes the same generator calls, with the same arguments
and seeds, as ``bench.py:_gen_one`` (both modules' generators patched to
record and return a tiny matrix, so nothing is built at full size);
``build_one`` and ``time_one`` give every field of a family's record on
``device="cpu"``; ``main`` runs every family in turn, records one family's
failure as its error and exits 1 when none lands; without CUDA and without
``--device cpu`` it exits non-zero, saying so, having measured nothing;
and the chained timing takes a rectangular handle, as
``tests/test_rect_bench.py::test_chain_timing_rect_protocol`` does for the
JAX package.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import spmv_tpu.io.generate as j_gen
import spmv_tpu_torch as st
import spmv_tpu_torch.io.generate as t_gen
from spmv_tpu_torch.bench import headline
from spmv_tpu_torch.bench.timing import time_spmv_chain

ROOT = os.path.join(os.path.dirname(__file__), "..")
GENERATORS = ("banded", "clustered", "random_uniform", "webbase_like",
              "power_law")
FIELDS = {"gflops", "gflops_marginal", "ms", "sync_bubble_ms", "nnz",
          "method", "value_mode", "predeal_ms", "pack_ms", "transfer_ms",
          "ref_gflops", "ref", "vs_ref"}


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_mod_torch_test", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_configs(fail=()):
    names = list(headline.REFS)
    configs = {}
    for name in names:
        ref_label, ref = headline.REFS[name]
        if name in fail:
            configs[name] = {"error": "Traceback (most recent call "
                                      "last)\n" + "x" * 400,
                             "ref_gflops": ref, "ref": ref_label}
            continue
        configs[name] = {
            "gflops": 1234.56, "gflops_marginal": 2345.67, "ms": 12.345,
            "sync_bubble_ms": 2.987, "nnz": 36_000_000,
            "method": "Method_SellCSigma", "value_mode": "palette_df",
            "predeal_ms": 75123.4, "pack_ms": 60123.4,
            "transfer_ms": 15000.0, "ref_gflops": ref, "ref": ref_label,
            "vs_ref": 123.45, "windows_ms": [12.345, 12.5],
        }
    return names, configs


def test_refs_are_bench_py_refs():
    """The nine families, their order and the reference figures are
    ``bench.py``'s."""
    assert headline.REFS == _load_bench().REFS
    assert list(headline.REFS) == list(_load_bench().REFS)


def test_compact_line_survives_tail(tmp_path, capsys):
    names, configs = _fake_configs()
    head = configs["banded4m"]
    line = headline.emit_records("banded4m", head, "cuda", names, configs,
                                 out_dir=str(tmp_path),
                                 gpu="NVIDIA H100 80GB HBM3, 700.00 W")
    assert len(line) < 1900
    rec = json.loads(line[-2000:])       # the whole line survives a tail
    assert rec["vs_baseline"] == head["vs_ref"]
    assert rec["backend"] == "cuda"
    assert rec["full"] == os.path.join(str(tmp_path), headline.RECORD)
    assert set(rec["families"]) == set(names)
    for fam in rec["families"].values():
        assert {"g", "vr", "pk", "tx"} <= set(fam)
    assert capsys.readouterr().out.strip().splitlines() == [line]


def test_full_record_on_disk(tmp_path):
    names, configs = _fake_configs(fail=("webbase1m",))
    line = headline.emit_records("banded4m", configs["banded4m"], "cuda",
                                 names, configs, out_dir=str(tmp_path),
                                 gpu="NVIDIA H100 80GB HBM3, 700.00 W")
    rec = json.loads(line)
    assert rec["families"]["webbase1m"] == {"e": 1}
    full = json.load(open(tmp_path / headline.RECORD))
    assert full["configs"]["uniform100k"]["pack_ms"] == 60123.4
    assert full["configs"]["uniform100k"]["transfer_ms"] == 15000.0
    assert "error" in full["configs"]["webbase1m"]
    assert full["gpu"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert "JAX round's host CPU" in full["refs"]
    # the protocol as the card runs it, and no TPU figure or prose
    proto = full["timing_protocol"]
    assert "CUDA events" in proto and "renorm" in proto
    assert not any(w in proto for w in ("tunnel", "2.9 ms", "TPU",
                                        "throttl"))


def test_default_record_goes_to_chiprun_out(monkeypatch, tmp_path, capsys):
    """Without ``out_dir`` the record goes to ``chiprun_out/`` under the
    checkout, never to the JAX package's ``baselines/bench_latest.json``,
    and the line names it relative to the checkout."""
    monkeypatch.setattr(headline, "ROOT", str(tmp_path))
    names, configs = _fake_configs()
    line = headline.emit_records("banded4m", configs["banded4m"], "cuda",
                                 names, configs)
    capsys.readouterr()
    assert json.loads(line)["full"] == "chiprun_out/bench_torch_latest.json"
    assert (tmp_path / "chiprun_out" / "bench_torch_latest.json").exists()
    assert not (tmp_path / "baselines").exists()


def test_compact_even_with_errors(tmp_path, capsys):
    names, configs = _fake_configs(
        fail=tuple(n for n in headline.REFS if n != "banded4m"))
    line = headline.emit_records("banded4m", configs["banded4m"], "cuda",
                                 names, configs, out_dir=str(tmp_path))
    capsys.readouterr()
    assert len(line) < 1900
    json.loads(line[-2000:])


def _recorders(monkeypatch, module, calls, tiny):
    """Patch ``module``'s generators to record their calls and return
    ``tiny`` (a matrix of that module's own types)."""
    for fn in GENERATORS:
        def rec(*args, _fn=fn, **kwargs):
            calls.append((_fn, args, kwargs))
            return tiny
        monkeypatch.setattr(module, fn, rec)


@pytest.mark.parametrize("name", list(headline.REFS))
def test_gen_one_makes_bench_py_calls(monkeypatch, name):
    bench = _load_bench()
    j_tiny = j_gen.random_uniform(40, 40, 3, dtype=np.float32, seed=1)
    t_tiny = t_gen.random_uniform(40, 40, 3, dtype=np.float32, seed=1)
    j_calls, t_calls = [], []
    _recorders(monkeypatch, j_gen, j_calls, j_tiny)
    _recorders(monkeypatch, t_gen, t_calls, t_tiny)
    want = bench._gen_one(name)
    got = headline.gen_one(name)
    assert len(t_calls) == 1 and t_calls == j_calls
    assert (got.m, got.n, got.nnz) == (want.m, want.n, want.nnz)
    np.testing.assert_array_equal(np.asarray(got.colidx),
                                  np.asarray(want.colidx))
    # _f64 families: f64 values from seed 7, bit for bit bench.py's
    assert np.asarray(got.vals).dtype == np.asarray(want.vals).dtype
    np.testing.assert_array_equal(np.asarray(got.vals),
                                  np.asarray(want.vals))


@pytest.mark.parametrize("name,dtype", [("uniform100k", np.float32),
                                        ("uniform100k_f64", np.float64)])
def test_build_and_time_one_on_cpu(name, dtype):
    # a band (AUTO: DIA), whose plain version runs fast enough on a loaded
    # CPU for the record's two-decimal GF/s to stay above 0
    a = t_gen.banded(20_000, 20_000, 4, dtype=dtype, seed=7)
    built = headline.build_one(name, a, "cpu")
    assert built["x"].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert built["nnz"] == a.nnz and built["predeal_ms"] > 0
    r = headline.time_one(built["handle"], built["x"])
    assert r["k"] == headline.K and r["inclusive"] > 0
    rec = headline.family_record(name, built, r, [r["inclusive"] * 1e3])
    assert FIELDS <= set(rec)
    assert rec["gflops"] > 0 and rec["gflops_marginal"] > 0
    assert rec["ref_gflops"] == headline.REFS[name][1]
    assert rec["method"] == built["handle"].method_name
    assert rec["pack_ms"] == round(rec["predeal_ms"] - rec["transfer_ms"], 1)


def _small_families(monkeypatch, fail=()):
    """gen_one → a small matrix of the family's type (``fail``: raise), and
    no 15 s between the windows."""
    def small(name):
        if name in fail:
            raise RuntimeError(f"{name} failed on purpose")
        dtype = np.float64 if name.endswith("_f64") else np.float32
        return t_gen.banded(20_000, 20_000, 4, dtype=dtype, seed=7)
    monkeypatch.setattr(headline, "gen_one", small)
    monkeypatch.setattr(headline, "GAP_S", 0)


def test_main_on_cpu_runs_every_family(monkeypatch, tmp_path, capsys):
    _small_families(monkeypatch, fail=("webbase1m",))
    rc = headline.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1
    rec = json.loads(out[0])
    assert rec["backend"] == "cpu"
    assert rec["metric"] == "spmv_gflops_banded4m"     # the headline rule
    assert rec["families"]["webbase1m"] == {"e": 1}
    assert all(f["g"] > 0 for n, f in rec["families"].items()
               if n != "webbase1m")
    full = json.load(open(tmp_path / headline.RECORD))
    assert "failed on purpose" in full["configs"]["webbase1m"]["error"]
    for name in headline.REFS:
        if name != "webbase1m":
            c = full["configs"][name]
            assert FIELDS <= set(c) and len(c["windows_ms"]) == 2
    assert full["gpu"] is None


def test_main_headline_falls_to_best_vs_ref(monkeypatch, tmp_path, capsys):
    _small_families(monkeypatch, fail=("banded4m",))
    assert headline.main(["--device", "cpu", "--out-dir",
                          str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    best = max((n for n in rec["families"] if "g" in rec["families"][n]),
               key=lambda n: rec["families"][n]["vr"])
    assert rec["metric"] == f"spmv_gflops_{best}"


def test_main_exits_1_when_no_family_lands(monkeypatch, tmp_path, capsys):
    _small_families(monkeypatch, fail=tuple(headline.REFS))
    assert headline.main(["--device", "cpu", "--out-dir",
                          str(tmp_path)]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == 0 and "error" in rec


def test_main_without_cuda_measures_nothing(monkeypatch, capsys):
    """The default device is CUDA, and there is no fallback: without a
    card the bench exits non-zero before it generates any matrix."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr(headline, "gen_one", lambda name: made.append(name))
    rc = headline.main([])
    cap = capsys.readouterr()
    assert rc != 0 and made == [] and cap.out == ""
    assert "no CUDA device was found" in cap.err


def test_chain_timing_rect_protocol():
    a = t_gen.banded(200, 300, 2, dtype=np.float64, seed=3)
    h = st.create_handle(a, method=st.Method.SERIAL, device="cpu")
    x = torch.from_numpy(t_gen.make_x(a.n, np.float64, kind="normal",
                                      seed=4))
    r = time_spmv_chain(h._bound, x, iters=3, k=4, repeats=1)
    assert r["inclusive"] > 0 and r["marginal"] > 0
