"""Seconds of ``GP.compute`` (host set-up, factorization, self-check; the
neighbour query and tables on the sparse path): a span the benchmark
takes around the public call, synchronized on both ends."""


def read(run):
    return run.spans.get("compute")
