"""The trace reduction and roofline arithmetic on synthetic events."""

import numpy as np
import pytest

from gpbench import trace as tr


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def synthetic():
    return [
        ev(tr.WINDOW, "user_annotation", 0, 100),
        ev("aten::mm", "cpu_op", 0, 30),
        ev("cudaLaunchKernel", "cuda_runtime", 3, 1),
        ev("aten::copy_", "cpu_op", 60, 35),
        ev("void chol_kernel<float, 0, 1>(...)", "kernel", 10, 10),
        ev("gemm", "kernel", 15, 10),                  # overlaps: 10..25
        ev("Memcpy DtoH", "gpu_memcpy", 70, 20, bytes=4e6),
        ev("void chol_kernel<float, 0, 1>(...)", "kernel", 95, 10),  # clipped
        ev("outside", "kernel", 200, 10),
    ]


def test_union_and_merge():
    assert tr.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_busy_idle_ops_copies():
    t = tr.Trace(synthetic())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx((15 + 20 + 5) * 1e-6)
    assert len(t.device) == 4
    assert t.copy_bytes() == 4e6
    assert [n for n, _ in t.top_ops(2)] == [
        "void chol_kernel<float, 0, 1>(...)", "Memcpy DtoH"]
    gaps = dict(t.idle_gaps())
    # 0..10 inside aten::mm, 25..70 split at its middle (47.5): nothing
    # spans it; 90..95 inside aten::copy_
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["host outside torch ops"] == pytest.approx(45e-6)
    assert gaps["aten::copy_"] == pytest.approx(5e-6)
    assert sum(gaps.values()) + t.busy_s() == pytest.approx(t.window_s)


def test_bound_seconds():
    p = tr.peaks()
    assert tr.bound_seconds(67e12, 0, "float32", p) == pytest.approx(1.0)
    assert tr.bound_seconds(0, 3.35e12, "float32", p) == pytest.approx(1.0)
    assert tr.bound_seconds(1e9, 3.35e9, "float64", p) == pytest.approx(1e-3)


class _Run(object):
    def __init__(self, trace, config, traffic, calls, x=None):
        self.trace, self.calls = trace, calls
        self.cell = type("C", (), {"config": config, "traffic": traffic,
                                   "data": type("D", (), {"x": x})})()


def test_leaf_roofline_counts_the_configuration():
    from gpbench.layer_metrics import leaf_chol_roofline
    cfg = {"dtype": "float32", "structure": {"leaves": 512,
                                             "leaf_size": 196}}
    t = tr.Trace(synthetic())
    got = leaf_chol_roofline.read(_Run(t, cfg, {"chains": 1}, 2))
    B, m = 1024, 196
    least = B * (m * (m + 1) // 2 + m * m) * 4 / 3.35e12
    assert got == pytest.approx(100 * least / 20e-6)


def test_dia_roofline_reads_the_width_from_the_instance():
    from gpbench.layer_metrics import dia_roofline
    x = np.arange(100) * 0.1                      # radius 0.25: 5 diagonals
    assert dia_roofline.band(x, 0.25) == 5
    cfg = {"dtype": "float32", "structure": {"band_radius": 0.25},
           "solver": {"options": {"num_probes": 16}}}
    evs = [ev(tr.WINDOW, "user_annotation", 0, 100),
           ev("void (anonymous namespace)::dia_stream_kernel<float, 1, 1, 8>"
              "(float const*)", "kernel", 0, 10),
           ev("void (anonymous namespace)::dia_stream_kernel<float, 4, 4, 8>"
              "(float const*)", "kernel", 20, 10)]
    got = dia_roofline.read(_Run(tr.Trace(evs), cfg, {}, 1, x))
    least = (100 * 5 + 3 * 100) * 4 / 3.35e12 + (100 * 5 + 33 * 100) * 4 \
        / 3.35e12
    assert got == pytest.approx(100 * least / 20e-6)
    evs[1]["name"] = "void dia_device_kernel<float>(float const*)"
    assert dia_roofline.read(_Run(tr.Trace(evs), cfg, {}, 1, x)) is None
