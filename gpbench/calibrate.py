"""Readings for the limits of a cell's comparison: the program's gaps from
the plain reference over many seeds, and the controls' gaps, in one
process on the card.

    python3 gpbench/calibrate.py --workload <name> --seeds 1 2 3 \
        [--controls reference_tf32 program_tf32] [--out PATH]

For each seed: the program at the cell's own sizes on the first
``check_calls`` inputs of the run's input stream, the float64 reference at
the same inputs, and each control in the program's place:
``reference_tf32`` (the reference in float32 with TF32 products) and
``program_tf32`` (the program with torch's TF32 matrix products switched
on). One JSON line per seed and reading goes to ``--out``.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def program_outputs(cell, inputs, device, tf32=False):
    """The program's outputs at ``inputs``, built and run with torch's TF32
    matrix products on or off (imported first: the package turns TF32 off
    when it is imported)."""
    import torch
    import george_tpu_torch  # noqa: F401
    from gpbench import program

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        gp = program.build_gp(cell.config, device, cell.solver_inputs)
        gp.compute(cell.data.x, cell.data.yerr)
        call = cell.entry.make_call(gp, cell)
        call(inputs[0])
        outs = [call(x) for x in inputs]
        del call, gp
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    _free()
    return outs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpbench.run import environment
    environment()
    import torch
    import george_tpu_torch  # noqa: F401
    from gpbench import harness

    device = "cuda"
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        cell = harness.Cell(args.workload, seed)
        k = cell.traffic["check_calls"]
        inputs = cell.entry.draw(harness.stream(seed, harness.STREAM_INPUTS),
                                 cell, k)
        t = time.perf_counter()
        got = {"program": program_outputs(cell, inputs, device)}
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        expected = cell.entry.reference(cell.reference(device), cell, inputs)
        t_ref = time.perf_counter() - t
        _free()
        for c in args.controls:
            try:
                if c == "reference_tf32":
                    got[c] = cell.entry.reference(
                        cell.reference(device, "tf32"), cell, inputs)
                else:
                    got[c] = program_outputs(cell, inputs, device, tf32=True)
            except (RuntimeError, ValueError) as err:
                got[c] = None
                print("seed %d %s raised %r" % (seed, c, err), flush=True)
            _free()
        for name, outs in got.items():
            row = {"workload": args.workload, "seed": seed, "reading": name,
                   "gaps": None if outs is None
                   else cell.entry.gaps(outs, expected),
                   "program_s": t_prog, "reference_s": t_ref,
                   "device": torch.cuda.get_device_name(0)}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
