# -*- coding: utf-8 -*-
"""The port's banded (DIA) matvec held against the JAX package's.

On the CPU the port's ``dia_matvec`` runs ``dia_matvec_plain``, the plain
torch version of the CUDA kernel; it is held against the TPU kernel
``dia_matvec_pallas`` in Pallas interpret mode and against ``dia_apply``,
at the recipe and bound of ``tests/test_ops.py`` (n=700, D=11, ragged row
blocks, vector and 4-column right-hand sides, 1e-12), on symmetric and
asymmetric bands. The kernel's launch plan is computed in Python
(``launch_plan``) and held here against the H100's limits at the shapes the
solver paths and ``chip_smoke.py`` use. The CUDA kernel itself runs only on
a card
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


# (n, D, r, dtype, variant): the bench band at the paths' column counts,
# chip_smoke's ragged and wide cases, a small first case, n below one tile
PLAN_SHAPES = [
    (200_000, 301, 1, torch.float32, "stream"),
    (200_000, 301, 16, torch.float32, "stream"),
    (200_000, 301, 17, torch.float32, "stream"),
    (200_000, 301, 40, torch.float32, "stream"),
    (200_000, 301, 4, torch.float64, "stream"),
    (200_000, 301, 1, torch.float64, "stream"),
    (200_037, 301, 17, torch.float32, "stream"),
    (50_000, 2001, 32, torch.float32, "device"),
    (5000, 301, 1, torch.float32, "stream"),
    (700, 7, 4, torch.float64, "stream"),
    (19, 11, 3, torch.float32, "stream"),
    (3, 1, 1, torch.float32, "stream"),
]


@pytest.mark.parametrize("n,D,r,dtype,variant", PLAN_SHAPES)
def test_launch_plan_fits_the_h100(n, D, r, dtype, variant):
    """The plan, computed on the CPU from the H100's limits: the variant,
    shared memory within the card's, 16-byte stages and offsets (what the
    bulk copies need), tile rows that keep every tile aligned, threads that
    match the kernel's layout, column groups that cover ``r``."""
    plan = tdia.launch_plan(n, D, r, dtype, limits=tdia.H100)
    assert plan.variant == variant
    assert tdia.uses_shared_memory(D, r, dtype, limits=tdia.H100) == (
        variant == "stream")
    assert plan.grid >= 1 and plan.threads >= 32
    if variant == "device":
        assert plan.smem_bytes == 0 and plan.grid == -(-n // 128)
        return
    size = dtype.itemsize
    assert plan.smem_bytes <= 232_448
    assert plan.ctas_per_sm * (plan.smem_bytes + 1024) <= 233_472
    assert plan.stage_bytes == plan.tile_rows * D * size
    for value in (plan.stage_bytes, plan.win_off, plan.ring_off):
        assert value % 16 == 0
    assert plan.tile_rows % (16 // size) == 0
    assert plan.tile_rows % plan.row_tile == 0
    assert 2 <= plan.stages <= 8
    assert plan.ring_off + plan.stages * plan.stage_bytes == plan.smem_bytes
    rows = plan.tiles_per_item * plan.tile_rows
    window = (rows + D - 1) * plan.win_stride * size
    assert plan.win_off + window <= plan.ring_off
    # column groups cover r, in whole 16-byte loads when there are several
    assert plan.groups * plan.passes * plan.col_tile >= r
    assert plan.win_stride >= -(-r // plan.col_tile) * plan.col_tile
    if r > 1:
        assert (plan.col_tile * size) % 16 == 0
        assert (plan.win_stride * size) % 16 == 0
    assert (r == 1) == (plan.row_tile == 1 and plan.col_tile == 1)
    # band segments cover D; one thread per (segment, group, row group)
    assert plan.segments * plan.seg_len >= D
    assert plan.threads == (plan.segments * plan.groups
                            * plan.tile_rows // plan.row_tile)
    assert plan.threads <= 512
    assert plan.grid == min(-(-n // rows), plan.ctas_per_sm * 132)


def test_every_planned_shape_has_its_instantiation():
    """The C launcher refuses a plan whose (type, R, C, NSEG) it was not
    compiled for: every plan over a grid of shapes names one of the
    instantiations listed in ``csrc/dia.cu``."""
    import os
    import re

    with open(os.path.join(_build.CSRC_DIR, "dia.cu")) as f:
        built = set(re.findall(
            r"X\((float|double), (\d+), (\d+), (\d+)\)", f.read()))
    assert built
    for dtype, name in ((torch.float32, "float"), (torch.float64, "double")):
        for D in (1, 7, 40, 301, 700, 2001, 5000):
            for r in (1, 2, 3, 4, 5, 8, 16, 17, 40, 100):
                plan = tdia.launch_plan(10_000, D, r, dtype, limits=tdia.H100)
                if plan.variant == "stream":
                    key = (name, str(plan.row_tile), str(plan.col_tile),
                           str(plan.segments))
                    assert key in built, (D, r, dtype, plan)
                    assert plan.threads <= 512
                    assert plan.smem_bytes <= 232_448


def test_launch_plan_avoids_bank_conflicts_on_the_bench_band():
    """At the bench band the chosen segment length and window stride leave
    the 16-byte window loads and the table loads of a warp conflict-free:
    4 wavefronts for 32 lanes x 16 bytes, 1 for each of the 4 table words."""
    plan = tdia.launch_plan(200_000, 301, 16, torch.float32, limits=tdia.H100)
    assert tdia._conflicts(301, plan.row_tile, plan.col_tile, plan.segments,
                           plan.groups, plan.seg_len, plan.win_stride, 1) == 8
    # the model itself: consecutive words, one bank, and 16-byte rows
    assert tdia._wavefronts(list(range(32)), 1) == 1
    assert tdia._wavefronts([32 * k for k in range(32)], 1) == 32
    assert tdia._wavefronts([0] * 32, 1) == 1
    assert tdia._wavefronts([4 * k for k in range(32)], 4) == 4
    assert tdia._wavefronts([16 * k for k in range(32)], 4) == 16


def test_launch_plan_overrides_and_refusals():
    plan = tdia.launch_plan(200_000, 301, 16, torch.float32, limits=tdia.H100,
                            tile_rows=16, ctas_per_sm=1, stages=3,
                            segments=16, item_rows=64)
    assert (plan.tile_rows, plan.ctas_per_sm, plan.stages, plan.segments,
            plan.tiles_per_item) == (16, 1, 3, 16, 4)
    assert plan.smem_bytes <= 232_448
    with pytest.raises(ValueError):
        tdia.launch_plan(0, 301, 1, torch.float32, limits=tdia.H100)


@pytest.mark.parametrize("offsets", BANDS, ids=["sym", "asym", "upper"])
@pytest.mark.parametrize("rhs", [1, 4], ids=["vector", "block"])
def test_operator_on_cpu_is_the_plain_version(offsets, rhs, monkeypatch):
    """The prepared apply the solver keeps: on CPU tensors it is
    ``dia_matvec_plain`` (and so the JAX ``dia_apply``) to 1e-12, and it
    builds nothing."""
    import jax.numpy as jnp
    from george_tpu.solvers.sparse import dia_apply

    def refuse():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tdia, "dia_kernel_launches", 0)
    rng = np.random.default_rng(4)
    n = 300
    vals, diag = _band(rng, n, offsets)
    y = rng.standard_normal((n,) if rhs == 1 else (n, rhs))
    op = tdia.DiaOperator(np.asarray(offsets), n)
    assert (op.d_min, op.D) == (offsets[0], len(offsets))
    args = (torch.as_tensor(vals), torch.as_tensor(diag), torch.as_tensor(y))
    out = op(*args).numpy()
    plain = tdia.dia_matvec_plain(args[0], offsets, args[1], args[2]).numpy()
    ref = np.asarray(dia_apply(jnp.asarray(vals), np.asarray(offsets),
                               jnp.asarray(diag), jnp.asarray(y)))
    np.testing.assert_allclose(out, plain, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    assert tdia.dia_kernel_launches == 0


def test_operator_takes_contiguous_offsets_only():
    with pytest.raises(ValueError):
        tdia.DiaOperator([0, 2, 3], 10)


@pytest.mark.parametrize("dtype,r,width", [
    (torch.float64, 512, 62), (torch.float32, 512, 124),
    (torch.float64, 40, 40), (torch.float32, 1, 1)],
    ids=["f64-r512", "f32-r512", "f64-r40", "f32-r1"])
def test_stream_width_on_the_bench_band(dtype, r, width):
    """A block wider than the streaming plan takes goes out in launches of
    the widest width it takes, on bench_dia's band (n = 2e5, D = 301)
    under the H100's limits; a block it takes goes out whole."""
    n, D = 200_000, 301
    w = tdia.stream_width(n, D, r, dtype, limits=tdia.H100)
    assert w == width
    assert tdia.launch_plan(n, D, w, dtype, limits=tdia.H100).variant == (
        "stream")
    if w < r:
        assert tdia.launch_plan(n, D, w + 1, dtype,
                                limits=tdia.H100).variant == "device"


def test_stream_width_keeps_the_device_kernel_for_wide_bands():
    """A band so wide that the streaming plan takes fewer than
    ``DEVICE_COLS`` columns goes to the device-memory kernel whole."""
    n, D, f32 = 50_000, 2001, torch.float32
    assert tdia.launch_plan(n, D, 32, f32, limits=tdia.H100).variant == (
        "device")
    assert tdia.launch_plan(n, D, 8, f32, limits=tdia.H100).variant == (
        "stream")
    assert tdia.stream_width(n, D, 32, f32, limits=tdia.H100) == 32


def test_split_columns_joins_the_blocks():
    """``split_columns`` applies a column-wise map block by block and
    joins the blocks into what one call gives."""
    rng = np.random.default_rng(6)
    offsets = BANDS[0]
    vals, diag = map(torch.as_tensor, _band(rng, 300, offsets))
    calls = []

    def apply(y):
        calls.append(tuple(y.shape))
        assert y.is_contiguous()
        return tdia.dia_matvec_plain(vals, offsets, diag, y)

    Y = torch.as_tensor(rng.standard_normal((300, 130)))
    whole = tdia.dia_matvec_plain(vals, offsets, diag, Y)
    np.testing.assert_array_equal(
        tdia.split_columns(apply, Y, 62).numpy(), whole.numpy())
    assert calls == [(300, 62), (300, 62), (300, 6)]
    calls.clear()
    tdia.split_columns(apply, Y[:, 0].contiguous(), 62)
    tdia.split_columns(apply, Y[:, :62].contiguous(), 62)
    assert calls == [(300,), (300, 62)]


def test_solver_keeps_one_operator_per_band(monkeypatch):
    """``SparseSolver.compute`` prepares the band's operator once; every
    apply goes through it and equals the plain version."""
    from george_tpu_torch import kernels
    from george_tpu_torch.solvers.sparse import SparseSolver

    def refuse():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 20.0, 400))
    k = kernels.WendlandC2Kernel(
        log_rc=np.log(1.5), kernel_base=kernels.ExpSquaredKernel(metric=1.0))
    s = SparseSolver(k, direct=False, device="cpu", num_probes=4)
    s.compute(x, 0.1)
    assert isinstance(s._dia, tdia.DiaOperator)
    assert (s._dia.d_min, s._dia.D) == tdia.band_range(s._dia_offsets)
    Y = torch.as_tensor(rng.standard_normal((400, 3)))
    plain = tdia.dia_matvec_plain(s._vals, s._dia_offsets, s._diag, Y)
    np.testing.assert_allclose(s._apply_fixed(Y).numpy(), plain.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s.apply_forward(Y.numpy()), plain.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("n,D,r,dtype,d_min", [
    (5000, 301, 1, torch.float32, None),
    (5000, 301, 16, torch.float32, None),
    (5037, 301, 17, torch.float32, None),
    (2000, 301, 40, torch.float32, None),
    (3000, 301, 4, torch.float64, None),
    (3000, 2001, 32, torch.float32, None),
    (5037, 301, 16, torch.float32, None),
    (19, 11, 3, torch.float32, None),
    (700, 7, 17, torch.float32, 2),
    (700, 7, 1, torch.float64, 2)])
def test_cuda_kernel_matches_plain(n, D, r, dtype, d_min):
    """The CUDA kernel against its plain version on the card: one column
    and register-tiled column groups (r = 17 and 40 end in a masked group,
    r = 40 takes two passes over a staged tile), a ragged last tile, n
    below one tile, an upper band (``d_min > 0``), and both variants (the
    D = 2001 case's window exceeds shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    if d_min is None:
        d_min = -(D // 2)
    offsets = tuple(range(d_min, d_min + D))
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
