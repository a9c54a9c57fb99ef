# -*- coding: utf-8 -*-
"""PyTorch twins of the JAX package's ``examples/*.py``: ``first``,
``scaling``, ``multioutput``, ``model``, ``mixture``, ``bayesopt``,
``hyper`` and ``spatial``.

Each keeps its JAX example's data (the same numpy seeds and streams),
function names, printed lines and asserts, and runs as::

    python -m george_tpu_torch.examples.<name> [its arguments] \\
        [--device cpu] [--dtype float32]

on the card by default, in float64. Where the JAX example picks a
tolerance by ``jax_enable_x64`` the twin picks it by ``--dtype``. Each
``main`` takes the example's arguments and ``device``/``dtype`` as
parameters and returns the numbers it printed, so a caller can hold them
against a reference. Nothing runs at import.
"""

import argparse

import torch

__all__ = ["parse_args"]

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def parse_args(argv=None, positional=(), flags=()):
    """A twin's command line: ``positional`` is a sequence of ``(name,
    type, default)`` optional positional arguments, ``flags`` the names of
    its ``--flag`` switches; ``--device`` (default ``"cuda"``) and
    ``--dtype`` (``float64`` or ``float32``, default ``float64``) are
    common to all. Returns the ``argparse`` namespace with ``dtype`` a
    torch dtype."""
    parser = argparse.ArgumentParser()
    for name, kind, default in positional:
        parser.add_argument(name, nargs="?", type=kind, default=default)
    for name in flags:
        parser.add_argument("--" + name, action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=sorted(_DTYPES),
                        default="float64")
    args = parser.parse_args(argv)
    args.dtype = _DTYPES[args.dtype]
    return args
