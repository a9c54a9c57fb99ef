"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. The last line of standard output is the result (JSON); the last
lines of standard error are the numbers compared with their limits. Exits
with another code than 0, and prints no result, without CUDA or enough
cards, without ``george_tpu_torch`` beside this folder, or when JAX or the
JAX package is loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".gpbench_cache")


def environment():
    """Fix the kernel and build caches at paths inside the checkout, and
    few host threads, the same in every run (before torch is imported)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "4"


def _log(msg):
    print("gpbench: " + msg, file=sys.stderr, flush=True)


def _fail(code, msg):
    _log(msg)
    sys.exit(code)


def main(argv=None):
    import argparse
    import json

    environment()

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpbench import guard
    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        _fail(2, "no workload %r in BENCHMARK.json" % args.workload)
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available():
        _fail(2, "no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < chips:
        _fail(2, "the cell asks for %d cards; %d present"
              % (chips, torch.cuda.device_count()))
    try:
        import george_tpu_torch  # noqa: F401
    except ImportError as err:
        _fail(2, "george_tpu_torch cannot be imported from %s: %s"
              % (ROOT, err))
    torch.set_num_threads(4)
    found = guard.forbidden_loaded()
    if found:
        _fail(3, "forbidden modules loaded at start: %s" % ", ".join(found))

    from gpbench.harness import run_cell

    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START, log=_log)
    found = guard.forbidden_loaded()
    if found:
        _fail(3, "forbidden modules loaded after the window: %s"
              % ", ".join(found))
    for name, value, limit in checks:
        _log("check %s %.6e limit %.6e %s" % (
            name, value, limit, "ok" if value <= limit else "FAILED"))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
