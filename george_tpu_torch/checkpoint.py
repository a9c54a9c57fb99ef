# -*- coding: utf-8 -*-
"""Checkpoints of long-running inference (PyTorch port of
``george_tpu/checkpoint.py``).

A checkpoint is a nested dict of arrays (walker or chain positions,
log-probabilities, tuned step sizes and mass matrices, the random key),
stored as one flat ``.npz``: nested dict keys join with ``/``, and every
list or tuple leaves a ``__seq__<path>/`` marker holding its length. The
layout is the JAX package's ``.npz`` layout, key for key, so a file written
by either package loads in the other. (The JAX package prefers orbax when
it is installed; the port writes ``.npz`` only.)

Tensors are stored as host numpy arrays. The random key of the port's
samplers is an int seed or a ``torch.Generator``; a generator is stored as
its ``get_state()``, a ``uint8`` array that ``Generator.set_state``
restores.

The samplers have no resume entry point; ``segment_size=`` splits a run
into bit-identical pieces, between which a caller may checkpoint.
"""

import os

import numpy as np
import torch

__all__ = ["save", "load", "sampler_state", "restore_sampler"]


def _flatten(tree, prefix=""):
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + str(k) + "/"))
    elif isinstance(tree, (list, tuple)):
        flat["__seq__" + prefix] = np.asarray([len(tree)], dtype=np.int64)
        for i, v in enumerate(tree):
            flat.update(_flatten(v, prefix + str(i) + "/"))
    else:
        flat[prefix.rstrip("/")] = np.asarray(tree)
    return flat


def _unflatten(flat):
    """Nested dicts back from the flat keys; a path with a ``__seq__``
    marker comes back as a list."""
    root = {}
    seqs = set()
    for key in flat:
        if key.startswith("__seq__"):
            seqs.add(key[len("__seq__"):].rstrip("/"))
    for key, val in flat.items():
        if key.startswith("__seq__"):
            continue
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def fix(node, path=""):
        if isinstance(node, dict):
            fixed = {k: fix(v, path + k + "/") for k, v in node.items()}
            if path.rstrip("/") in seqs:
                return [fixed[str(i)] for i in range(len(fixed))]
            return fixed
        return node

    return fix(root)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Generator):
        return tree.get_state().numpy()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save(path, state):
    """Write a nested dict of arrays and tensors to ``path`` (``.npz`` is
    appended when missing); returns the file's path."""
    flat = _flatten(_to_numpy(state))
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, **flat)
    return path


def load(path):
    """Read a checkpoint written by :func:`save` (of either package)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat)


def sampler_state(walkers, log_probs, key, step=0, step_size=None,
                  inv_mass=None, extras=None):
    """The canonical sampler checkpoint: ``walkers`` and ``log_probs``
    (arrays or tensors), ``key`` (an int seed or a ``torch.Generator``),
    the step count, and optionally the step sizes, the inverse mass (an
    array, or the dense sampler's ``{"sigma", "chol"}``) and ``extras``."""
    state = {
        "walkers": _to_numpy(walkers),
        "log_probs": _to_numpy(log_probs),
        "key": _to_numpy(key),
        "step": np.asarray(step, dtype=np.int64),
    }
    if step_size is not None:
        state["step_size"] = _to_numpy(step_size)
    if inv_mass is not None:
        state["inv_mass"] = _to_numpy(inv_mass)
    if extras:
        state["extras"] = _to_numpy(extras)
    return state


def restore_sampler(path):
    """Load a sampler checkpoint; returns the state dict."""
    return load(path)
