# -*- coding: utf-8 -*-
"""The port has the JAX package's public names, and the last four that it
lacked behave as the JAX package's do: ``Kernel.sparse``,
``solvers.sparse.cg_diff_solve``, ``utils.nd_sort_samples`` and
``kernels.codegen.generate`` / ``check``.

The walk imports every module of ``george_tpu`` (importing changes nothing
there) and reads its ``__all__``, or, where a module has none, the
functions and classes it defines; the port's module of the same dotted
path must have each name, apart from ``EXCLUDED``, where every name
carries its reason.
"""

import importlib
import inspect
import os
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import george_tpu
import george_tpu_torch

torch.set_num_threads(2)

NOT_TO_PORT = "ROADMAP 'Not to port'"
PALLAS = "Pallas entry point, replaced by a CUDA kernel in csrc/"

# (module, name) -> reason; name None excludes the whole module and the
# modules under it
EXCLUDED = {
    ("george_tpu.native", None):
        NOT_TO_PORT + ": native/kdtree.py (the port's radius query is one "
        "vectorized cKDTree.query_pairs)",
    ("george_tpu.ops.ds", None):
        NOT_TO_PORT + ": ops/ds.py double-single cores",
    ("george_tpu.ops", "pallas_cholesky"): PALLAS + "chol.cu",
    ("george_tpu.ops", "pallas_cholesky_blocked"): PALLAS + "chol.cu",
    ("george_tpu.ops", "dia_matvec_pallas"): PALLAS + "dia.cu",
    ("george_tpu.ops.chol", "pallas_cholesky"): PALLAS + "chol.cu",
    ("george_tpu.ops.dia", "dia_matvec_pallas"): PALLAS + "dia.cu",
    ("george_tpu.ops.dia", "DIA_VMEM_BUDGET"):
        NOT_TO_PORT + ": the Pallas kernel's VMEM budget (TPU tiling)",
    ("george_tpu.utils", "full_precision_matmuls"):
        NOT_TO_PORT + ": the TPU's matmul-precision pins (the port turns "
        "TF32 off once, george_tpu_torch/__init__.py)",
    ("george_tpu.utils", "pinned_full_precision"):
        NOT_TO_PORT + ": the TPU's matmul-precision pins",
}


def _excluded(module, name):
    for (mod, nm), _ in EXCLUDED.items():
        if nm is None and (module == mod or module.startswith(mod + ".")):
            return True
        if module == mod and name == nm:
            return True
    return False


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__]


def test_port_has_every_public_name():
    """Every name in the JAX package's modules' ``__all__`` (or, without
    one, every function and class a module defines) is in the port's
    module of the same path, apart from ``EXCLUDED``; and every exclusion
    still names something the JAX package has."""
    missing, seen = [], set()
    for info in pkgutil.walk_packages(george_tpu.__path__, "george_tpu."):
        name = info.name
        if _excluded(name, None):
            seen.update(k for k in EXCLUDED if k[0] == name)
            continue
        mod = importlib.import_module(name)
        port = importlib.import_module(
            "george_tpu_torch" + name[len("george_tpu"):])
        for n in _public_names(mod):
            if _excluded(name, n):
                seen.add((name, n))
            elif not hasattr(port, n):
                missing.append("%s.%s" % (name, n))
    assert not missing, missing
    assert seen == set(EXCLUDED), set(EXCLUDED) - seen


def test_port_kernel_sparse_attribute():
    """``sparse`` on every kernel class: False on the base ``Kernel``, True
    only on ``WendlandC2Kernel``, as in the JAX package."""
    from george_tpu import kernels as jk
    from george_tpu_torch import kernels as tk

    assert tk.Kernel.sparse is False
    assert tk.ExpSquaredKernel(1.0).sparse is False
    assert tk.WendlandC2Kernel(
        log_rc=0.5, kernel_base=tk.ExpSquaredKernel(1.0)).sparse is True
    for n in jk.__all__:
        cls = getattr(jk, n)
        if inspect.isclass(cls) and hasattr(cls, "sparse"):
            assert getattr(tk, n).sparse is cls.sparse, n


@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_port_cg_diff_solve_matches_jax_grad(shape):
    """``cg_diff_solve`` through a matvec that closes over the kernel's
    parameters: the solution, and the gradient of a weighted sum of it in
    those parameters, the diagonal and the right-hand side, against
    ``jax.grad`` through the JAX package's ``cg_diff_solve``; and forward
    mode against ``jax.jvp``."""
    from george_tpu.solvers import sparse as JS
    from george_tpu_torch.solvers import sparse as TS

    rng = np.random.default_rng(0)
    n = shape[0]
    x = np.sort(rng.uniform(0, 10, n))
    b = rng.standard_normal(shape)
    w = rng.standard_normal(shape)
    theta = np.array([0.3, -0.2])                   # log amplitude, log ell
    diag = 0.1 + rng.uniform(0, 0.1, n)
    d2 = (x[:, None] - x[None, :]) ** 2

    def jax_loss(th, dg, rhs):
        K = jnp.exp(th[0]) * jnp.exp(-0.5 * d2 * jnp.exp(-2 * th[1]))
        A = K + jnp.diag(dg)
        z = JS.cg_diff_solve(lambda v: A @ v, rhs, jnp.diag(A), tol=1e-13)
        return jnp.sum(w * z), z

    def torch_loss(th, dg, rhs):
        d2t = torch.as_tensor(d2)
        K = torch.exp(th[0]) * torch.exp(-0.5 * d2t * torch.exp(-2 * th[1]))
        A = K + torch.diag(dg)
        z = TS.cg_diff_solve(lambda v: A @ v, rhs, torch.diagonal(A),
                             tol=1e-13)
        return torch.sum(torch.as_tensor(w) * z), z

    args = (theta, diag, b)
    (vj, zj), gj = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                      has_aux=True)(*map(jnp.asarray, args))
    targs = [torch.tensor(a).requires_grad_(True) for a in args]
    vt, zt = torch_loss(*targs)
    gt = torch.autograd.grad(vt, targs)
    A = (np.exp(theta[0]) * np.exp(-0.5 * d2 * np.exp(-2 * theta[1]))
         + np.diag(diag))
    np.testing.assert_allclose(zt.detach().numpy(), np.linalg.solve(A, b),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj),
                               rtol=1e-9, atol=1e-9)
    for a, c in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-8,
                                   atol=1e-10)
    # torch.func.grad (create_graph backward) gives the same gradient
    gf = torch.func.grad(lambda *a: torch_loss(*a)[0], argnums=(0, 1, 2))(
        *[torch.tensor(a) for a in args])
    for a, c in zip(gf, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-8,
                                   atol=1e-10)
    # forward mode in theta
    t = np.array([0.7, -0.4])
    _, tj = jax.jvp(lambda th: jax_loss(th, diag, b)[0],
                    (jnp.asarray(theta),), (jnp.asarray(t),))
    _, tt = torch.func.jvp(
        lambda th: torch_loss(th, torch.tensor(diag), torch.tensor(b))[0],
        (torch.tensor(theta),), (torch.tensor(t),))
    assert abs(float(tt) - float(tj)) < 1e-8 * max(abs(float(tj)), 1.0)


def test_port_utils_nd_sort_samples():
    from george_tpu import utils as ju
    from george_tpu_torch import utils as tu

    x = np.random.default_rng(3).uniform(0, 5, (300, 2))
    assert np.array_equal(tu.nd_sort_samples(x), ju.nd_sort_samples(x))


def test_port_codegen_generate_and_check(tmp_path):
    """``generate`` writes the checked-in source and returns every spec's
    kernel name, the JAX package's list; ``check`` passes; ``main`` runs
    through them. The JAX side writes only under ``tmp_path``."""
    from george_tpu.kernels import codegen as jc
    from george_tpu_torch.kernels import codegen as tc

    out = str(tmp_path / "generated.py")
    names = tc.generate(output=out)
    with open(out) as f, open(tc.OUTPUT) as g:
        assert f.read() == g.read()
    assert names == jc.generate(output=str(tmp_path / "jax_generated.py"))
    assert tc.check() is True
    assert tc.main(["--check"]) == 0
    assert os.path.exists(tc.OUTPUT)
