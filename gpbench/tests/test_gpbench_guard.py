"""The import and path guard: nothing the benchmark loads is JAX or the
JAX package, the reference loads nothing of the program, and no file of
the benchmark opens the JAX package's benchmark scripts."""

import os
import subprocess
import sys

from gpbench import guard

from .conftest import ROOT


def test_names_are_compared_whole():
    assert guard.forbidden_loaded(["george_tpu_torch", "george_tpu_torch.gp",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["george_tpu.gp", "jaxlib.xla", "jax",
                                   "flax.linen"]) == ["flax", "george_tpu",
                                                      "jax", "jaxlib"]


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = _loaded(
        "import gpbench.run as r, gpbench.harness as h\n"
        "import george_tpu_torch\n"
        "h.Cell('hodlr_smooth_1e5.fit', 1).reference('cpu')\n"
        "h.Cell('sparse_dia_2e5.fit', 1)\n"
        "import gpbench.program, gpbench.trace, gpbench.calibrate\n"
        "import gpbench.layer_metrics.dia_roofline\n"
        "import gpbench.layer_metrics.leaf_chol_roofline")
    assert "george_tpu_torch" in names
    assert not names & guard.FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _loaded(
        "import numpy as np\n"
        "from gpbench.reference import gp, kernel\n"
        "import gpbench.reference.kernels.Constant\n"
        "import gpbench.reference.kernels.ExpSquared\n"
        "import gpbench.reference.kernels.Matern32\n"
        "import gpbench.reference.kernels.WendlandC2\n"
        "n = kernel.build({'scale': [1.0, {'ExpSquared': {'metric': 1.0}}]})\n"
        "g = gp.BandedGP(n, np.arange(50.0), np.ones(50), 'cpu')\n"
        "g.loglike_and_grad(np.array(n.theta0), np.ones(50))")
    assert not names & (guard.FORBIDDEN | {"george_tpu_torch"})


def test_no_file_opens_the_jax_packages_scripts():
    banned = ("chip" + "_smoke", "bench" + ".py", "bench" + "marks/",
              "bench" + "marks.")
    here = os.path.abspath(__file__)
    for dirpath, _, files in os.walk(os.path.join(ROOT, "gpbench")):
        for f in files:
            path = os.path.join(dirpath, f)
            if not f.endswith(".py") or path == here:
                continue
            with open(path) as fh:
                text = fh.read()
            for b in banned:
                assert b not in text, (path, b)
