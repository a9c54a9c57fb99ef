# -*- coding: utf-8 -*-
"""The samplers' random streams.

A sampler takes a ``torch.Generator`` or an int seed in place of the JAX
package's ``PRNGKey``. Before the first step the sampler draws one int64
seed per step from it; each step then draws everything it needs from a
generator seeded with its own seed, on the sampling device. So a run cut
into segments draws exactly what the unsegmented run draws, step for
step: the two are bit-identical.
"""

import torch

__all__ = ["step_seeds", "step_generator"]


def step_seeds(key, count):
    """``count`` int64 seeds drawn from ``key`` (a ``torch.Generator``, or
    an int that seeds a CPU generator), as Python ints."""
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    return torch.randint(0, 2 ** 62, (int(count),), generator=gen,
                         device=gen.device).tolist()


def step_generator(seed, device):
    """The generator of one step, on ``device``."""
    return torch.Generator(device=device).manual_seed(int(seed))
