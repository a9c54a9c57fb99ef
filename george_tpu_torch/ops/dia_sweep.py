# -*- coding: utf-8 -*-
"""Check and time the DIA kernel over launch-plan choices, on one CUDA card.

Builds the kernels, prints what ``ptxas`` says of the DIA instantiations
(registers, spills), checks the kernel against ``dia_matvec_plain`` at small
and ragged shapes (first, so a broken pipeline shows on a small table),
prints the host's cost per call of the two entry points, and then times
the kernel at the bench band (n = 2e5, D = 301) for each column count
under the default plan and under every override asked for. Times are
milliseconds per launch from one pair of CUDA events around ``--launches``
back-to-back launches (the host's share per launch vanishes behind the
device's), median of ``--repeats``::

    python -m george_tpu_torch.ops.dia_sweep            # default plans
    python -m george_tpu_torch.ops.dia_sweep --sweep    # and the overrides

The result goes to standard output and, with ``--json PATH``, to a JSON
file.
"""

import argparse
import itertools
import json
import os
import subprocess
import time

import numpy as np
import torch

from . import _build, dia


def _band(n, D, r, dtype, seed, d_min=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    d_min = -(D // 2) if d_min is None else d_min
    offsets = np.arange(d_min, d_min + D)
    vals = torch.randn((n, D), generator=g, device="cuda", dtype=dtype)
    cols = (torch.arange(n, device="cuda")[:, None]
            + torch.as_tensor(offsets, device="cuda")[None, :])
    vals = torch.where((cols >= 0) & (cols < n), vals, 0.0).contiguous()
    diag = torch.rand(n, generator=g, device="cuda", dtype=dtype) + 1.0
    shape = (n,) if r == 0 else (n, r)
    y = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    return vals, offsets, diag, y


def _launch(vals, offsets, diag, y, plan):
    """One launch under ``plan`` instead of the default plan."""
    d_min, D = dia.band_range(offsets)
    n = y.shape[0]
    r = 1 if y.ndim == 1 else y.shape[1]
    entry = dia._bind(n, D, r, y.dtype, y.device.index,
                      vals.data_ptr() % 16 == 0, plan=plan)
    return dia._launch(vals, diag, y, d_min, D, entry)


def check(n, D, r, dtype, d_min=None, plan_kw=None, offset_view=False):
    vals, offsets, diag, y = _band(n, D, r, dtype, seed=n % 97, d_min=d_min)
    if offset_view:
        # a table whose base is not 16-byte aligned: no bulk copies
        flat = torch.empty(n * D + 1, device="cuda", dtype=dtype)
        flat[1:] = vals.reshape(-1)
        vals = flat[1:].view(n, D)
    rr = max(r, 1)
    plan = dia.launch_plan(n, D, rr, dtype, **(plan_kw or {}))
    out = _launch(vals, offsets, diag, y, plan)
    torch.cuda.synchronize()
    ref = dia.dia_matvec_plain(vals, offsets, diag, y)
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    ok = err <= tol and bool(torch.isfinite(out).all())
    print("check n=%d D=%d d_min=%s r=%d %s %s%s: rel err %.3e %s [%s]"
          % (n, D, d_min, r, str(dtype).split(".")[-1], plan_kw or "",
             " unaligned" if offset_view else "", err,
             "ok" if ok else "FAILED", plan), flush=True)
    return ok


def time_plan(vals, offsets, diag, y, plan, launches, repeats):
    d_min, D = dia.band_range(offsets)
    n = y.shape[0]
    r = 1 if y.ndim == 1 else y.shape[1]
    entry = dia._bind(n, D, r, y.dtype, y.device.index,
                      vals.data_ptr() % 16 == 0, plan=plan)
    for _ in range(3):
        out = dia._launch(vals, diag, y, d_min, D, entry)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            out = dia._launch(vals, diag, y, d_min, D, entry)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return float(np.median(times)), out


def host_cost(calls=3000):
    """Host microseconds per call of the two entry points (and of the two
    ways to the current stream), on a table small enough that the device
    never holds the host back."""
    n, D = 2000, 301
    vals, offsets, diag, y = _band(n, D, 0, torch.float32, seed=7)
    op = dia.DiaOperator(offsets, n)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    cases = [
        ("prepared apply (DiaOperator)", lambda: op(vals, diag, y)),
        ("dia_matvec_cuda", lambda: dia.dia_matvec_cuda(vals, offsets, diag,
                                                        y)),
        ("torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("one torch op (y + y)", lambda: y + y)]
    if raw is not None:
        cases.append(("torch._C._cuda_getCurrentRawStream", lambda: raw(0)))
    out = {}
    for name, fn in cases:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print("host %s: %.2f us per call" % (name, out[name]), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time the plan overrides too")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--D", type=int, default=301)
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--r", type=int, nargs="+", default=[1, 16, 17],
                    help="column counts to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dia_sweep needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("card: %s" % card, flush=True)
    _build.load()
    print("build %.1f s" % _build.build_info.get("seconds", 0.0))
    name = None
    for line in _build.build_info.get("log", "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "dia_" in name and ("registers" in line
                                          or "spill" in line):
            print("  %s: %s" % (name, line.strip()), flush=True)

    f32, f64 = torch.float32, torch.float64
    ok = True
    # small first: a wrong barrier phase shows here, not on the 241 MB table
    for case in [(5000, 301, 1, f32), (5000, 301, 0, f32),
                 (5000, 301, 16, f32), (5037, 301, 17, f32),
                 (5000, 301, 4, f32), (5003, 301, 8, f32), (700, 7, 2, f32),
                 (5001, 301, 7, f64),
                 (2000, 301, 40, f32), (3000, 301, 4, f64),
                 (3001, 301, 1, f64), (700, 11, 4, f64), (700, 7, 1, f32),
                 (19, 11, 3, f32), (3, 1, 2, f32), (1000, 40, 5, f32),
                 (3000, 2001, 32, f32), (3000, 700, 8, f32)]:
        ok &= check(*case)
    ok &= check(700, 7, 4, f32, d_min=2)
    ok &= check(700, 7, 1, f64, d_min=2)
    ok &= check(700, 11, 3, f32, d_min=-9)
    ok &= check(5001, 301, 16, f32, offset_view=True)
    ok &= check(5001, 301, 1, f32, offset_view=True)
    for kw in ({"segments": 16}, {"segments": 32}, {"tile_rows": 16},
               {"tile_rows": 8, "stages": 3}, {"ctas_per_sm": 1},
               {"item_rows": 64}):
        ok &= check(5037, 301, 17, f32, plan_kw=kw)
        ok &= check(5001, 301, 1, f64, plan_kw=kw)
    if not ok:
        raise SystemExit("dia_sweep: a check failed")

    host = host_cost()
    results = []
    n, D = args.n, args.D
    for r in args.r:
        vals, offsets, diag, y = _band(n, D, 0 if r == 1 else r, f32, seed=r)
        ref = dia.dia_matvec_plain(vals, offsets, diag, y)
        scale = float(ref.abs().max())
        grid = [{}]
        if args.sweep:
            tiles = [{"tile_rows": t, "ctas_per_sm": c, "stages": s}
                     for t, c, s in itertools.product((32, 16), (1, 2, 3, 4),
                                                      (2, 3))]
            grid += tiles
            grid += [dict(t, segments=16) for t in tiles if r > 1]
            grid += [{"item_rows": m} for m in (64, 96, 160, 256)]
            grid += [{"segments": 8}, {"segments": 16}, {"segments": 32}]
        seen = set()
        for kw in grid:
            try:
                plan = dia.launch_plan(n, D, r, f32, **kw)
            except ValueError:
                continue
            if plan in seen or plan.variant != "stream":
                continue
            seen.add(plan)
            ms, out = time_plan(vals, offsets, diag, y, plan, args.launches,
                                args.repeats)
            err = float((out - ref).abs().max()) / scale
            results.append({"r": r, "override": kw, "ms": ms, "rel_err": err,
                            "plan": plan._asdict()})
            print("time r=%d %s: %.4f ms (rel err %.1e) %s"
                  % (r, kw, ms, err, plan), flush=True)
            if err > 1e-5:
                raise SystemExit("dia_sweep: wrong result under %s" % (plan,))
        best = min((x for x in results if x["r"] == r), key=lambda x: x["ms"])
        print("best r=%d: %.4f ms %s" % (r, best["ms"], best["override"]),
              flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "n": n, "D": D,
                       "launches": args.launches, "repeats": args.repeats,
                       "host_us": host, "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
