# -*- coding: utf-8 -*-
"""The samplers' cross-chain reductions.

Every sampler holds its chains (or walkers) along dimension 0 and reduces
across them in a few places only: the pooled mass-matrix statistics, the
step-size clip's median, the stretch move's partner lookup, the loops'
stopping tests and the random draws. Those places go through a reducer.
:class:`LocalChains` is the reducer of a sampler whose chains all live in
this process: every method is the plain operation, so an unsharded run is
the same computation as before the reducers existed. ``parallel``
supplies the reducer of chains sharded over a process group, with the
same methods backed by collectives.
"""

import torch

__all__ = ["LocalChains"]


class LocalChains(object):
    """The reducer of chains that all live in this process."""

    def total(self, local):
        """The number of chains across all shards, given this shard's."""
        return local

    def rows(self, full):
        """This shard's rows of an array over all chains."""
        return full

    def gather(self, local):
        """All shards' rows (dimension 0), in chain order."""
        return local

    def sum(self, partial):
        """The sum over shards of per-shard partial sums."""
        return partial

    def mean(self, local):
        """The mean over all chains (dimension 0)."""
        return torch.mean(local, dim=0)

    def any(self, flags):
        """Whether any chain's flag is set, as a Python bool (one read
        of the device)."""
        return bool(flags.any())
