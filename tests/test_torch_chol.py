# -*- coding: utf-8 -*-
"""The port's batched leaf Cholesky held against the JAX package's.

On the CPU the port's ``cholesky`` runs ``cholesky_plain``, the plain
torch version of the CUDA kernel's recurrence; it is held against the TPU
kernel ``pallas_cholesky_blocked`` in Pallas interpret mode, at the cases
and bounds of ``tests/test_ops.py``; ``cholesky_plain`` is also the plain
version of the tiled one-warp-per-block kernel, and is held against the
unblocked TPU kernel ``pallas_cholesky`` too. The CUDA
kernels themselves run only on a card (the tests marked ``cuda``) and in
``chip_smoke.py``.

JAX is imported inside the tests that use it, so that the ``cuda`` test
also runs on a machine without JAX::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_chol.py
"""

import numpy as np
import pytest
import torch

from george_tpu_torch.ops import _build
from george_tpu_torch.ops import chol as tchol

torch.set_num_threads(2)


def _spd_batch(rng, B, m, dtype=np.float32, near_singular=False):
    """Random SPD blocks shaped like the solver's leaf boxes (the recipe of
    ``tests/test_ops.py``)."""
    X = rng.standard_normal((B, m, 3 * m))
    A = X @ np.swapaxes(X, -1, -2) / (3 * m)
    A += (1e-4 if near_singular else 1.0) * np.eye(m)[None]
    return A.astype(dtype)


@pytest.mark.parametrize("B,m", [(8, 128), (6, 196), (16, 64), (4, 256)])
def test_plain_matches_pallas_blocked(B, m):
    import jax.numpy as jnp
    from george_tpu.ops.chol import pallas_cholesky_blocked

    A = _spd_batch(np.random.default_rng(3), B, m)
    L_ref = np.asarray(pallas_cholesky_blocked(jnp.asarray(A), block_tile=4,
                                               interpret=True))
    L = tchol.cholesky(torch.as_tensor(A)).numpy()
    assert L.dtype == np.float32
    # the bound of tests/test_ops.py: f32, two different column orders
    assert np.allclose(L, L_ref, atol=3e-5 * np.abs(L_ref).max())
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))


def test_plain_near_singular_stays_finite():
    A = _spd_batch(np.random.default_rng(5), 4, 128, near_singular=True)
    L = tchol.cholesky_plain(torch.as_tensor(A)).numpy()
    assert np.isfinite(L).all()
    rec = np.einsum("bik,bjk->bij", L, L)
    assert np.allclose(rec, A, atol=5e-4)


def test_plain_pivot_floor():
    """A zero pivot takes the 1e-30 floor (finite, no NaN), as the TPU
    kernel's does."""
    A = torch.zeros((1, 3, 3), dtype=torch.float64)
    A[0, 0, 0] = 4.0
    L = tchol.cholesky_plain(A)
    assert torch.isfinite(L).all()
    assert float(L[0, 0, 0]) == 2.0


def test_backward_matches_jax_grad():
    import jax
    import jax.numpy as jnp
    from george_tpu.ops.chol import cholesky as jax_cholesky

    A = _spd_batch(np.random.default_rng(6), 3, 32, dtype=np.float64)

    def loss_jax(M):
        L = jax_cholesky(M)
        return jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1))) + (
            0.01 * jnp.sum(L ** 2))

    At = torch.as_tensor(A).requires_grad_(True)
    L = tchol.cholesky(At)
    loss = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1))) + (
        0.01 * torch.sum(L ** 2))
    (g,) = torch.autograd.grad(loss, At)
    gj = np.asarray(jax.grad(loss_jax)(jnp.asarray(A)))
    assert np.allclose(g.numpy(), gj, atol=1e-9)
    # the pullback is symmetric, as the reference's
    assert np.allclose(g.numpy(), np.swapaxes(g.numpy(), -1, -2), atol=0)


def test_cpu_tensor_never_builds(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tchol, "chol_kernel_launches", 0)
    A = torch.as_tensor(_spd_batch(np.random.default_rng(1), 2, 16))
    tchol.cholesky(A)
    tchol.cholesky(A.double().requires_grad_(True)).sum().backward()
    assert tchol.chol_kernel_launches == 0


@pytest.mark.parametrize("bad", ["cpu", "ndim", "square", "dtype"])
def test_cuda_wrapper_refuses_before_launch(bad):
    """``cholesky_cuda`` checks its input before it builds or launches."""
    A = torch.eye(4).expand(2, 4, 4).contiguous()
    if bad == "ndim":
        A = A[0]
    elif bad == "square":
        A = A[:, :, :3]
    elif bad == "dtype":
        A = A.half()
    with pytest.raises((ValueError, TypeError)):
        tchol.cholesky_cuda(A)


def test_cholesky_takes_batches_only():
    with pytest.raises(ValueError):
        tchol.cholesky(torch.eye(3))


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,dtype", [(512, 196, torch.float32),
                                       (64, 489, torch.float32),
                                       (16, 196, torch.float64)])
def test_cuda_kernel_matches_plain(B, m, dtype):
    """The CUDA kernel (both variants) against its plain version on the
    card, at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    A = torch.as_tensor(_spd_batch(rng, B, m, dtype=np.float64)).to(
        "cuda", dtype)
    before = tchol.chol_kernel_launches
    L = tchol.cholesky_cuda(A)
    torch.cuda.synchronize()
    assert tchol.chol_kernel_launches == before + 1
    L_ref = tchol.cholesky_plain(A)
    tol = (1e-4 if dtype == torch.float32 else 1e-10) * float(
        L_ref.abs().max())
    assert float((L - L_ref).abs().max()) <= tol
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tiled_plain_matches_pallas_cholesky(dtype):
    """The tiled kernel's plain version against the unblocked TPU kernel at
    its one caller's case (``tests/test_ops.py:39-46``, (8, 128),
    ``block_tile=4``): 3e-5 max|L| in float32 (that test's bound), 1e-12
    max|L| in float64."""
    import jax.numpy as jnp
    from george_tpu.ops.chol import pallas_cholesky

    A = _spd_batch(np.random.default_rng(4), 8, 128, dtype=dtype)
    L_ref = np.asarray(pallas_cholesky(jnp.asarray(A), block_tile=4,
                                       interpret=True))
    L = tchol.cholesky_plain(torch.as_tensor(A)).numpy()
    assert L.dtype == dtype
    tol = 3e-5 if dtype == np.float32 else 1e-12
    assert np.allclose(L, L_ref, rtol=0, atol=tol * np.abs(L_ref).max())
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))


@pytest.mark.parametrize("bad", ["cpu", "ndim", "square", "dtype"])
def test_tiled_cuda_wrapper_refuses_before_launch(bad):
    A = torch.eye(4).expand(2, 4, 4).contiguous()
    if bad == "ndim":
        A = A[0]
    elif bad == "square":
        A = A[:, :, :3]
    elif bad == "dtype":
        A = A.half()
    with pytest.raises((ValueError, TypeError)):
        tchol.cholesky_tiled_cuda(A)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,dtype,per_cta", [(8, 128, torch.float32, 3),
                                               (1024, 64, torch.float32, 8),
                                               (16, 64, torch.float64, 6),
                                               (4, 196, torch.float64, 0)])
def test_cuda_tiled_kernel_matches_plain(B, m, dtype, per_cta):
    """The tiled kernel against its plain version on the card: blocks in
    shared memory (3, 8 and 6 per CTA) and in device memory (f64 m=196)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert tchol.tile_blocks_per_cta(m, dtype) == per_cta
    A = torch.as_tensor(_spd_batch(np.random.default_rng(0), B, m,
                                   dtype=np.float64)).to("cuda", dtype)
    before = tchol.chol_tile_kernel_launches
    L = tchol.cholesky_tiled_cuda(A)
    torch.cuda.synchronize()
    assert tchol.chol_tile_kernel_launches == before + 1
    L_ref = tchol.cholesky_plain(A)
    tol = (1e-4 if dtype == torch.float32 else 1e-10) * float(
        L_ref.abs().max())
    assert float((L - L_ref).abs().max()) <= tol
    assert bool((torch.triu(L, 1) == 0).all())
