# -*- coding: utf-8 -*-
"""The port's banded (DIA) matvec held against the JAX package's.

On the CPU the port's ``dia_matvec`` runs ``dia_matvec_plain``, the plain
torch version of the CUDA kernel; it is held against the TPU kernel
``dia_matvec_pallas`` in Pallas interpret mode and against ``dia_apply``,
at the recipe and bound of ``tests/test_ops.py`` (n=700, D=11, ragged row
blocks, vector and 4-column right-hand sides, 1e-12), on symmetric and
asymmetric bands. The CUDA kernel itself runs only on a card
(``test_cuda_kernel_matches_plain``, marked ``cuda``) and in
``chip_smoke.py``::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_dia.py
"""

import numpy as np
import pytest
import torch

from george_tpu_torch.ops import _build
from george_tpu_torch.ops import dia as tdia

torch.set_num_threads(2)

BANDS = [tuple(range(-5, 6)), tuple(range(-7, 4)), tuple(range(2, 9))]


def _band(rng, n, offsets, dtype=np.float64):
    """A random band with its out-of-range slots zeroed, and a diagonal."""
    vals = rng.standard_normal((n, len(offsets)))
    for j, d in enumerate(offsets):
        idx = np.arange(n) + d
        vals[(idx < 0) | (idx >= n), j] = 0.0
    return vals.astype(dtype), rng.uniform(1, 2, n).astype(dtype)


@pytest.mark.parametrize("offsets", BANDS, ids=["sym", "asym", "upper"])
@pytest.mark.parametrize("rhs", [1, 4], ids=["vector", "block"])
def test_plain_matches_pallas_and_dia_apply(offsets, rhs):
    import jax.numpy as jnp
    from george_tpu.ops.dia import dia_matvec_pallas
    from george_tpu.solvers.sparse import dia_apply

    rng = np.random.default_rng(0)
    n = 700
    vals, diag = _band(rng, n, offsets)
    y = rng.standard_normal((n,) if rhs == 1 else (n, rhs))
    valsj, diagj, yj = jnp.asarray(vals), jnp.asarray(diag), jnp.asarray(y)
    ref = np.asarray(dia_apply(valsj, np.asarray(offsets), diagj, yj))
    ref_pallas = np.asarray(dia_matvec_pallas(
        valsj, offsets, diagj, yj, block_rows=256, interpret=True))
    out = tdia.dia_matvec(torch.as_tensor(vals), offsets,
                          torch.as_tensor(diag), torch.as_tensor(y)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out, ref_pallas, rtol=1e-12, atol=1e-12)


def test_plain_is_the_dense_band():
    """The band's meaning, independent of either package: the dense matrix
    with ``K[i, i + d] = vals[i, j]`` plus the diagonal."""
    rng = np.random.default_rng(1)
    n, offsets = 50, tuple(range(-3, 5))
    vals, diag = _band(rng, n, offsets)
    K = np.diag(diag)
    for j, d in enumerate(offsets):
        for i in range(n):
            if 0 <= i + d < n:
                K[i, i + d] += vals[i, j]
    y = rng.standard_normal((n, 3))
    out = tdia.dia_matvec_plain(torch.as_tensor(vals), offsets,
                                torch.as_tensor(diag), torch.as_tensor(y))
    np.testing.assert_allclose(out.numpy(), K @ y, rtol=1e-12, atol=1e-12)


def test_cpu_tensor_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tdia, "dia_kernel_launches", 0)
    rng = np.random.default_rng(2)
    vals, diag = _band(rng, 40, BANDS[0], dtype=np.float32)
    tdia.dia_matvec(torch.as_tensor(vals), BANDS[0], torch.as_tensor(diag),
                    torch.ones(40))
    assert tdia.dia_kernel_launches == 0


def test_band_range_takes_contiguous_offsets_only():
    assert tdia.band_range(np.arange(-4, 3)) == (-4, 7)
    assert tdia.band_range((2, 3, 4)) == (2, 3)
    for bad in ([0, 2, 3], [1, 0], []):
        with pytest.raises(ValueError):
            tdia.band_range(bad)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "mixed"])
def test_cuda_wrapper_refuses_before_launch(bad):
    """``dia_matvec_cuda`` checks its inputs before it builds or launches."""
    vals, diag, y = torch.zeros(8, 3), torch.ones(8), torch.ones(8)
    if bad == "dtype":
        vals, diag, y = vals.half(), diag.half(), y.half()
    elif bad == "shape":
        diag = torch.ones(7)
    elif bad == "mixed":
        y = y.double()
    with pytest.raises((ValueError, TypeError)):
        tdia.dia_matvec_cuda(vals, (-1, 0, 1), diag, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,D,r,dtype", [(5000, 301, 1, torch.float32),
                                         (5000, 301, 16, torch.float32),
                                         (5037, 301, 17, torch.float32),
                                         (2000, 301, 40, torch.float32),
                                         (3000, 301, 4, torch.float64),
                                         (3000, 2001, 32, torch.float32)])
def test_cuda_kernel_matches_plain(n, D, r, dtype):
    """The CUDA kernel against its plain version on the card: both
    instantiations (one column; 16 per pass, so r = 17 and 40 take
    several passes over each row) and both variants (the last case's
    window exceeds shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    offsets = tuple(range(-(D // 2), D - D // 2))
    vals, diag = _band(rng, n, offsets)
    y = rng.standard_normal((n, r))
    vals, diag, y = (torch.as_tensor(a).to("cuda", dtype)
                     for a in (vals, diag, y))
    assert tdia.uses_shared_memory(D, r, dtype) == (D < 2001)
    before = tdia.dia_kernel_launches
    out = tdia.dia_matvec_cuda(vals, offsets, diag, y)
    torch.cuda.synchronize()
    assert tdia.dia_kernel_launches == before + 1
    ref = tdia.dia_matvec_plain(vals, offsets, diag, y)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
