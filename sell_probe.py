#!/usr/bin/env python3
"""Probes of the SELL kernel (``spmv_tpu_torch/csrc/sell.cu``) on one
NVIDIA card: where its time goes, and whether its one-launch epilogue is
sound.  Run from the repository root:

    python3 sell_probe.py chunks      # the chunk rule's settings
    python3 sell_probe.py variants    # copies of the kernel, one part changed
    python3 sell_probe.py stress      # partial-sum scratch poisoned with NaN

Streams are those of ``sell_ab.py`` (each SELL kernel's largest stream in
``chip_smoke.py``), packed once on the host.  Each prints one JSON line a
stream; device times are ``chip_smoke.profile_calls``' median of 5
profile windows.

* ``chunks``: the stream placed under other values of
  ``ops.sell.CHUNKS_PER_SM`` and ``ops.sell.MAX_REDUCE_BYTES`` (the shipped
  pair first), each checked against the plain version and timed.
* ``variants``: ``sell.cu`` compiled again with one change each, into
  ``spmv_tpu_torch/_build/variants/``, and timed on K6's, a K1 slot
  stripe's and K9's stream: ``nogather`` (slot x gathers replaced by a
  constant: wrong results, timed only), ``nocell`` (the cell's meta read
  from the slot's own word: wrong results), ``ku1``/``ku4`` (tiles
  decoded at once), ``ring32`` (32 KB rings).
* ``stress``: 300 launches a stream at 2 and 4 chunks an SM (output
  blocks of many chunks), each after the block the caching allocator hands
  out as the partial-sum scratch was filled with NaN; every launch must
  match the plain version and the first launch's bits, and leave the
  tickets at 0.

Exits non-zero without a card, or when ``stress`` finds a launch wrong.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

CHUNK_SETTINGS = [(2, 1 << 20), (2, 1 << 18), (2, 1 << 40), (1, 1 << 20),
                  (4, 1 << 20)]
VARIANTS = {
    "nogather": [("? __ldg(x + base[u] + off[u][i]) : T(0);",
                  "? T(off[u][i]) : T(0);")],
    "nocell": [("const uint32_t mc = mt[i * kLanes + (ms & 127u)];",
                "const uint32_t mc = ms;")],
    "ku1": [("constexpr int kU = 2;", "constexpr int kU = 1;")],
    "ku4": [("constexpr int kU = 2;", "constexpr int kU = 4;")],
    "ring32": [("constexpr int kRingBytes = 16 * 1024;",
                "constexpr int kRingBytes = 32 * 1024;")],
}


def build_variants():
    """{name: spmv_sell_launch} of each variant, compiled at once."""
    from spmv_tpu_torch import _build
    base = _build.load_kernels()
    src = open(os.path.join(_build.CSRC_DIR, "sell.cu")).read()
    vdir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(vdir, exist_ok=True)
    cmd = [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", _build.CSRC_DIR]

    def build(name):
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in sell.cu")
            text = text.replace(old, new)
        path = os.path.join(vdir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        res = subprocess.run(cmd + [path, "-o", path[:-3] + ".so"],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"variant {name}: {res.stderr[-2000:]}")
        fn = ctypes.CDLL(path[:-3] + ".so").spmv_sell_launch
        fn.restype = base.spmv_sell_launch.restype
        fn.argtypes = base.spmv_sell_launch.argtypes
        return name, fn

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(pool.map(build, VARIANTS))
    fns["base"] = base.spmv_sell_launch
    return base, fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=("chunks", "variants", "stress"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sell_probe.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    import sell_ab
    from spmv_tpu_torch import _build
    from spmv_tpu_torch.ops import sell
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    kernels = {"variants": ["sell_slot_w", "sell_slot", "sell_v1"],
               "stress": ["sell_row", "sell_row_df", "sell_v1",
                          "sell_v1_df", "sell_slot_w"]}.get(args.probe)
    if args.probe == "variants":
        base, fns = build_variants()
    defaults = sell.CHUNKS_PER_SM, sell.MAX_REDUCE_BYTES
    failed = 0
    for label, st in sell_ab.streams(dev, kernels):
        fields = sell_ab.host_fields(st)
        kern = cs.kernel_of(st)
        del st
        x = None
        rec = {"probe": args.probe, "kernel": kern, "stream": label}
        for cps, mrb in (CHUNK_SETTINGS if args.probe == "chunks"
                         else [(defaults[0], defaults[1])]
                         + ([(4, defaults[1])] if args.probe == "stress"
                            else [])):
            sell.CHUNKS_PER_SM, sell.MAX_REDUCE_BYTES = cps, mrb
            s2 = sell_ab.place(sell, fields, dev)
            sell.CHUNKS_PER_SM, sell.MAX_REDUCE_BYTES = defaults
            if x is None:
                x = torch.from_numpy(rng.standard_normal(s2.n).astype(
                    np.float64 if s2.dtype == torch.float64
                    else np.float32)).to(dev)
                ref = sell.sell_plain(s2, x)
                absref = sell.sell_plain(cs.abs_stream(s2), x.abs())
                bound = (cs.BOUND_F64_KERNEL if x.dtype == torch.float64
                         else cs.BOUND)
                rec.update(tiles=s2.meta.shape[0], nw=s2.nw,
                           nblocks=s2.nblocks)
            fn = lambda v: sell.sell_spmv(s2, v)  # noqa: E731
            key = f"cps{cps}_reduce{mrb}"
            most = int(np.diff(s2.block_chunk_ptr.cpu().numpy()).max())
            if args.probe == "chunks":
                ok = cs.scaled_err(fn(x), ref, absref, bound)[2]
                rec[key] = {"chunks": s2.nchunks, "most_a_block": most,
                            "ok": ok,
                            "device_ms": cs.profile_calls(fn, x)["device_ms"]}
            elif args.probe == "variants":
                for name in ("base", *VARIANTS, "base"):
                    _build._kernels = SimpleNamespace(
                        **{**vars(base), "spmv_sell_launch": fns[name]})
                    ok = cs.scaled_err(fn(x), ref, absref, bound)[2]
                    rec.setdefault(name, []).append(
                        {"ok": ok,
                         "device_ms": cs.profile_calls(fn, x)["device_ms"]})
                _build._kernels = base
            else:
                y0 = fn(x).clone()
                wrong = differ = 0
                worst = 0.0
                for _ in range(300):
                    torch.full((s2.nchunks * 1024,), float("nan"),
                               dtype=s2.dtype, device=dev)
                    y = fn(x)
                    rel, _abs, ok = cs.scaled_err(y, ref, absref, bound)
                    wrong += not ok
                    differ += not torch.equal(y, y0)
                    worst = max(worst, rel)
                left = int(s2.ticket.count_nonzero())
                failed += wrong + differ + left
                rec[key] = {"chunks": s2.nchunks, "most_a_block": most,
                            "launches": 300, "wrong": wrong,
                            "differ": differ, "worst_scaled_err": worst,
                            "tickets_left": left}
            del s2
        cs.log(json.dumps(rec))
        del x, ref, absref
        torch.cuda.empty_cache()
    cs.log(cs._cmd_line(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
