"""Each configuration's data is its published recipe's numpy stream at the
published seed (the recipes written out here as the benchmark scripts
they come from draw them)."""

import numpy as np

from gpbench.harness import Cell, stream


def published_smooth(n, seed=42):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1000.0, n))[:, None]
    y = np.sin(0.1 * x[:, 0]) + 0.3 * rng.standard_normal(n)
    return x[:, 0], y, np.sqrt(0.09 * np.ones(n))


def published_dia(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, n / 50.0, n))
    rng.standard_normal(n)              # the matvec check's right-hand side
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    return x, y, 0.1 * np.ones(n)


def test_recipes_at_published_seeds():
    for workload, published in (
            ("hodlr_smooth_1e5.fit", published_smooth(100_000)),
            ("sparse_dia_2e5.fit", published_dia(200_000))):
        cell = Cell(workload, Cell(workload, 0).config["dataset"][
            "published_seed"])
        for got, want in zip((cell.data.x, cell.data.y, cell.data.yerr),
                             published):
            assert np.array_equal(got, want)


def test_seed_streams_are_distinct_and_repeat():
    a = stream(2 ** 33 + 5, 1).standard_normal(4)
    assert np.array_equal(a, stream(2 ** 33 + 5, 1).standard_normal(4))
    assert not np.array_equal(a, stream(2 ** 33 + 5, 2).standard_normal(4))
    assert not np.array_equal(a, stream(2 ** 33 + 6, 1).standard_normal(4))


def test_probes_come_from_the_seed():
    a = Cell("sparse_dia_2e5.fit", 7).solver_inputs
    b = Cell("sparse_dia_2e5.fit", 7).solver_inputs
    assert a["probes"].shape == (16, 200_000)
    assert set(np.unique(a["probes"])) == {-1.0, 1.0}
    assert np.array_equal(a["probes"], b["probes"])
    assert not np.array_equal(a["probes"], a["grad_probes"])


def test_sparse_inputs_are_the_same_for_every_seed():
    a, b = Cell("sparse_dia_2e5.fit", 5).data, Cell("sparse_dia_2e5.fit", 6).data
    assert np.array_equal(a.x, b.x)
    assert not np.array_equal(a.y, b.y)
