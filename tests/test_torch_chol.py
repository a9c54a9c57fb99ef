# -*- coding: utf-8 -*-
"""The port's batched leaf Cholesky held against the JAX package's.

On the CPU the port's ``cholesky`` runs ``cholesky_plain``, the plain
torch version of the CUDA kernel's recurrence; it is held against the TPU
kernel ``pallas_cholesky_blocked`` in Pallas interpret mode, at the cases
and bounds of ``tests/test_ops.py``, both column by column (``panel=1``)
and with the kernel's deferred per-panel update (``panel=PANEL``);
``cholesky_plain`` is also the plain version of the tiled entry point,
and is held against the unblocked TPU kernel ``pallas_cholesky`` too. The
kernel's launch plan is computed in Python and checked here against the
card's limits. The CUDA kernels themselves run only on a card (the tests
marked ``cuda``) and in ``chip_smoke.py``.

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


@pytest.mark.parametrize("B,m,dtype", [(2, 196, np.float32),
                                       (2, 196, np.float64),
                                       (3, 33, np.float32),
                                       (3, 33, np.float64),
                                       (3, 64, np.float64)])
def test_plain_panel_matches_pallas_blocked(B, m, dtype):
    """The kernel's order of operations (``panel=PANEL``: in-panel updates
    column by column, the trailing block once per panel) against the TPU
    kernel, which defers its update the same way, at ragged tails (196 =
    6 x 32 + 4, 33 = 32 + 1) and at a panel boundary (64): 3e-5 max|L| in
    float32, 1e-12 in float64."""
    import jax.numpy as jnp
    from george_tpu.ops.chol import pallas_cholesky_blocked

    A = _spd_batch(np.random.default_rng(7), B, m, dtype=dtype)
    L_ref = np.asarray(pallas_cholesky_blocked(jnp.asarray(A), block_tile=B,
                                               interpret=True))
    L = tchol.cholesky_plain(torch.as_tensor(A), panel=tchol.PANEL).numpy()
    assert L.dtype == dtype
    tol = 3e-5 if dtype == np.float32 else 1e-12
    assert np.allclose(L, L_ref, rtol=0, atol=tol * np.abs(L_ref).max())
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))


@pytest.mark.parametrize("m", [5, 33, 64, 196])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_panel_matches_column_order(m, dtype):
    """``panel=PANEL`` against ``panel=1`` (the solver's CPU path), and
    ``panel=1`` against LAPACK's factor."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(8), 3, m,
                                   dtype=dtype))
    L1 = tchol.cholesky_plain(A)
    Lp = tchol.cholesky_plain(A, panel=tchol.PANEL)
    tol = (3e-5 if dtype == np.float32 else 1e-12) * float(L1.abs().max())
    assert float((Lp - L1).abs().max()) <= tol
    assert float((L1 - torch.linalg.cholesky(A)).abs().max()) <= tol
    assert bool((torch.triu(Lp, 1) == 0).all())


def test_plain_panel_one_is_the_column_recurrence():
    """``panel=1`` is the column recurrence step for step: every column's
    rank-1 update of the whole trailing block, in column order."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(9), 2, 40,
                                   dtype=np.float64))
    S = A.clone()
    L = torch.zeros_like(A)
    for k in range(40):
        inv = torch.rsqrt(torch.clamp_min(S[:, k, k], 1e-30))
        col = S[:, k:, k] * inv[:, None]
        L[:, k:, k] = col
        S[:, k + 1:, k + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    assert torch.equal(tchol.cholesky_plain(A), L)


# every shape the paths launch: the leaf kernel at the HODLR leaves (f32
# and f64 at n = 1e5, f32 at n = 1e6, 4 and 8 chains' leaves at n = 1e5
# in one launch under vmap) and the shapes checked on the card; the tiled
# entry point at its timed and checked shapes
_PLAN_CASES = [
    (512, 196, torch.float32, False), (512, 196, torch.float64, False),
    (2048, 196, torch.float32, False), (4096, 196, torch.float32, False),
    (2048, 196, torch.float64, False), (4096, 196, torch.float64, False),
    (2048, 489, torch.float32, False), (64, 489, torch.float32, False),
    (32, 489, torch.float32, False), (16, 196, torch.float64, False),
    (4, 196, torch.float64, False), (4, 128, torch.float32, False),
    (2, 1900, torch.float32, False), (8, 128, torch.float32, True),
    (1024, 64, torch.float32, True), (16, 64, torch.float64, True),
    (4, 196, torch.float64, True), (4, 128, torch.float32, True),
    (3, 1, torch.float64, True)]


@pytest.mark.parametrize("B,m,dtype,tiled", _PLAN_CASES)
def test_launch_plan_fits_the_card(B, m, dtype, tiled):
    """No plan asks for more shared memory than the H100's opt-in limit or
    for more threads than a CTA may have (a launch refused for either never
    runs), and every block of the batch is covered."""
    plan = tchol.launch_plan(B, m, dtype, tiled, limits=tchol.H100)
    assert plan.smem_bytes <= tchol.H100.smem_per_cta
    assert plan.cta_threads <= min(1024, tchol.MAX_CTA_THREADS)
    assert plan.group_threads % 32 == 0 and plan.group_threads >= 32
    assert plan.cta_threads == plan.group_threads * plan.blocks_per_cta
    assert 1 <= plan.blocks_per_cta <= tchol.MAX_BLOCKS_PER_CTA
    assert plan.grid * plan.blocks_per_cta >= B
    assert (plan.grid - 1) * plan.blocks_per_cta < B
    assert plan.smem_bytes == plan.blocks_per_cta * tchol._group_bytes(
        m, dtype.itemsize, plan.variant)
    if plan.variant == "device-panel":
        assert plan.smem_bytes == 0


def test_launch_plan_geometry():
    """The plans the design asks for: two 256-thread blocks of m=196 per
    SM in float32 (packed triangle, 108 KB each), one 512-thread block in
    float64; f32 m=489 in device memory, three 320-thread CTAs per SM; the
    tiled entry point with many warps on one block at (8, 128) and eight
    two-warp blocks per CTA at (1024, 64); the panel in device memory when
    even it does not fit."""
    H = tchol.H100

    def plan(*a):
        return tchol.launch_plan(*a, limits=H)

    p = plan(512, 196, torch.float32)
    assert (p.variant, p.group_threads, p.blocks_per_cta) == (
        "shared", 256, 1)
    assert 2 * (p.smem_bytes + tchol.CTA_RESERVED_SMEM) <= H.smem_per_sm
    p = plan(512, 196, torch.float64)
    assert (p.variant, p.group_threads) == ("shared", 512)
    p = plan(2048, 489, torch.float32)
    assert (p.variant, p.group_threads) == ("device", 320)
    assert 3 * (p.smem_bytes + tchol.CTA_RESERVED_SMEM) <= H.smem_per_sm
    p = plan(8, 128, torch.float32, True)
    assert p.blocks_per_cta == 1 and p.group_threads >= 256
    p = plan(1024, 64, torch.float32, True)
    assert (p.group_threads, p.blocks_per_cta, p.grid) == (64, 8, 128)
    p = plan(1, 4000, torch.float64)
    assert (p.variant, p.smem_bytes) == ("device-panel", 0)


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
@pytest.mark.parametrize("B,m,dtype,variant", [
    (512, 196, torch.float32, "shared"), (64, 489, torch.float32, "device"),
    (32, 489, torch.float32, "device"), (16, 196, torch.float64, "shared"),
    (512, 196, torch.float64, "shared"),
    (2, 1900, torch.float32, "device-panel")])
def test_cuda_kernel_matches_plain(B, m, dtype, variant):
    """The CUDA kernel (every variant) against its plain version on the
    card, at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert tchol.launch_plan(B, m, dtype).variant == variant
    rng = np.random.default_rng(0)
    A = torch.as_tensor(_spd_batch(rng, B, m, dtype=np.float64)).to(
        "cuda", dtype)
    before = tchol.chol_kernel_launches
    L = tchol.cholesky_cuda(A)
    torch.cuda.synchronize()
    assert tchol.chol_kernel_launches == before + 1
    L_ref = tchol.cholesky_plain(A, panel=tchol.PANEL)
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
@pytest.mark.parametrize("B,m,dtype,per_cta", [(8, 128, torch.float32, 1),
                                               (1024, 64, torch.float32, 8),
                                               (16, 64, torch.float64, 1),
                                               (4, 196, torch.float64, 1)])
def test_cuda_tiled_kernel_matches_plain(B, m, dtype, per_cta):
    """The tiled entry point against its plain version on the card: one
    block with many warps per CTA (small batches) and eight blocks per CTA
    ((1024, 64))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert tchol.launch_plan(B, m, dtype, tiled=True).blocks_per_cta == (
        per_cta)
    A = torch.as_tensor(_spd_batch(np.random.default_rng(0), B, m,
                                   dtype=np.float64)).to("cuda", dtype)
    before = tchol.chol_tile_kernel_launches
    L = tchol.cholesky_tiled_cuda(A)
    torch.cuda.synchronize()
    assert tchol.chol_tile_kernel_launches == before + 1
    L_ref = tchol.cholesky_plain(A, panel=tchol.PANEL)
    tol = (1e-4 if dtype == torch.float32 else 1e-10) * float(
        L_ref.abs().max())
    assert float((L - L_ref).abs().max()) <= tol
    assert bool((torch.triu(L, 1) == 0).all())


def _vmap_loss(L):
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1))) + (
        0.01 * torch.sum(L ** 2))


def test_vmap_folds_the_mapped_dimension_into_one_call(monkeypatch):
    """Under ``torch.func.vmap`` a ``(C, B, m, m)`` batch is one call of the
    forward on ``(C * B, m, m)``, and the value and ``vmap(grad)`` match the
    per-member calls (CPU: the plain version; float64, 1e-12)."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(2), 24, 32,
                                   dtype=np.float64)).reshape(3, 8, 32, 32)
    calls = []
    forward = tchol._forward
    monkeypatch.setattr(tchol, "_forward",
                        lambda X: calls.append(tuple(X.shape)) or forward(X))
    L = torch.func.vmap(tchol.cholesky)(A)
    assert calls == [(24, 32, 32)]
    g = torch.func.vmap(torch.func.grad(
        lambda M: _vmap_loss(tchol.cholesky(M))))(A)
    assert calls[1:] == [(24, 32, 32)]
    for c in range(3):
        assert float((L[c] - tchol.cholesky(A[c])).abs().max()) <= 1e-12
        gc = torch.func.grad(lambda M: _vmap_loss(tchol.cholesky(M)))(A[c])
        assert float((g[c] - gc).abs().max()) <= 1e-12 * float(
            gc.abs().max())


@pytest.mark.cuda
def test_cuda_vmap_is_one_launch():
    """On the card, ``vmap`` of the Cholesky over a ``(3, 8, 128, 128)``
    batch is ONE kernel launch of 24 blocks; its value matches the three
    per-member launches and its ``vmap(grad)`` the per-member gradients
    (float32: 1e-5 of max|L|, 1e-4 of max|grad|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A = torch.as_tensor(_spd_batch(np.random.default_rng(3), 24, 128,
                                   dtype=np.float64)).to(
        "cuda", torch.float32).reshape(3, 8, 128, 128)
    before = tchol.chol_kernel_launches
    L = torch.func.vmap(tchol.cholesky)(A)
    torch.cuda.synchronize()
    assert tchol.chol_kernel_launches == before + 1
    g = torch.func.vmap(torch.func.grad(
        lambda M: _vmap_loss(tchol.cholesky(M))))(A)
    torch.cuda.synchronize()
    assert tchol.chol_kernel_launches == before + 2
    for c in range(3):
        Lc = tchol.cholesky(A[c].contiguous())
        assert float((L[c] - Lc).abs().max()) <= 1e-5 * float(
            Lc.abs().max())
        gc = torch.func.grad(lambda M: _vmap_loss(tchol.cholesky(M)))(
            A[c].contiguous())
        assert float((g[c] - gc).abs().max()) <= 1e-4 * float(
            gc.abs().max())
