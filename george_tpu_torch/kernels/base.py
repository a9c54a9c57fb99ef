# -*- coding: utf-8 -*-
"""Kernel base classes and the functional (torch) evaluation path
(PyTorch port of ``george_tpu/kernels/base.py``).

Every kernel object compiles itself to a pure *broadcast* pair function

    ``pair(theta, x1, x2) -> k``

where ``theta`` is the kernel's full parameter vector (frozen parameters
included) as a tensor, and ``x1``/``x2`` are point arrays ``(..., d)``
that broadcast against each other; the result has the broadcast shape
``(...)``. A covariance block is one call (:meth:`Kernel.gram`), a
diagonal is a call on matching rows, and the hierarchical solver's batched
leaf and skeleton blocks are calls on suitably unsqueezed index gathers.
Hyperparameter gradients come from autograd (``torch.func.jacfwd`` of the
block function) instead of hand-derived formulas.

The stateful methods (``get_value``, ``get_gradient``, the ``nns=``
sparse forms, ``get_x1_gradient``/``get_x2_gradient`` and the ``test_*``
finite-difference checks) keep george's API and return types (numpy, or
``scipy.sparse.csr_matrix`` for ``nns=``) and evaluate in float64 on
``device`` (default ``"cuda"``; pass ``device="cpu"`` on a host without a
card).
"""

import numpy as np
import torch

from ..modeling import ModelSet
from ..metrics import metric_r2_fn

__all__ = [
    "Kernel",
    "Sum",
    "Product",
    "StationaryKernel",
    "NonStationaryKernel",
    "safe_sqrt",
    "M_PI",
]

M_PI = np.pi


def safe_sqrt(r2):
    """``sqrt(r2)`` with a well-defined (zero) derivative at ``r2 == 0``.

    Plain ``torch.sqrt`` has an infinite derivative at zero, which turns the
    diagonal entries of stationary-kernel gradients into NaN via
    ``inf * 0``. The double-``where`` form gives the same values and a zero
    derivative there, in reverse mode and in forward mode alike (the
    Hutchinson gradient differentiates kernels with ``torch.func.jvp``):
    the branch that is not taken sees ``sqrt(1)``, whose derivative is
    finite, and its tangent is masked to zero.
    """
    positive = r2 > 0.0
    safe = torch.where(positive, r2, 1.0)
    return torch.where(positive, torch.sqrt(safe), 0.0)


class Kernel(ModelSet):
    """Abstract covariance kernel following the modeling protocol.

    Supports ``+`` and ``*`` composition (scalars are lifted to
    :class:`ConstantKernel`).
    """

    is_kernel = True
    kernel_type = -1
    stationary = False
    sparse = False
    operator_type = -1
    _constant_names = ()
    _base_param_names = ()

    # ------------------------------------------------------------------
    # Algebra
    # ------------------------------------------------------------------

    def __add__(self, b):
        if not hasattr(b, "is_kernel"):
            from .generated import ConstantKernel

            return Sum(
                ConstantKernel(
                    log_constant=np.log(float(b) / self.ndim), ndim=self.ndim
                ),
                self,
            )
        return Sum(self, b)

    def __radd__(self, b):
        return self.__add__(b)

    def __mul__(self, b):
        if not hasattr(b, "is_kernel"):
            from .generated import ConstantKernel

            return Product(
                ConstantKernel(
                    log_constant=np.log(float(b) / self.ndim), ndim=self.ndim
                ),
                self,
            )
        return Product(self, b)

    def __rmul__(self, b):
        return self.__mul__(b)

    # numpy-scalar arithmetic support (``np.float64(2) * kernel``)
    def __array_wrap__(self, array, context=None, return_scalar=False):
        if context is None:
            raise TypeError("Invalid operation")
        ufunc, args, _ = context
        if ufunc.__name__ == "multiply":
            return float(args[0]) * args[1]
        elif ufunc.__name__ == "add":
            return float(args[0]) + args[1]
        raise TypeError("Invalid operation")

    __array_priority__ = np.inf

    # ------------------------------------------------------------------
    # Attribute plumbing
    # ------------------------------------------------------------------

    def __getattr__(self, name):
        models = self.__dict__.get("models")
        if models is not None:
            if name in models:
                return models[name]
            if None in models:
                return getattr(models[None], name)
        raise AttributeError(name)

    def __getstate__(self):
        odict = self.__dict__.copy()
        odict.pop("_pair_fn", None)
        return odict

    def __setstate__(self, state):
        self.__dict__.update(state)

    # ------------------------------------------------------------------
    # Functional compile
    # ------------------------------------------------------------------

    @property
    def pair_fn(self):
        """The compiled broadcast pair function ``(theta, x1, x2) -> k``."""
        fn = self.__dict__.get("_pair_fn")
        if fn is None:
            fn = self._compile()
            self.__dict__["_pair_fn"] = fn
        return fn

    def _compile(self):
        raise NotImplementedError("kernel subclasses must implement _compile")

    def gram(self, theta, x1, x2):
        """Covariance block ``K[..., i, j] = k(x1[..., i], x2[..., j])``
        for point arrays ``(..., m, d)`` and ``(..., n, d)``."""
        return self.pair_fn(theta, x1[..., :, None, :], x2[..., None, :, :])

    @property
    def input_ndim(self):
        """Width of the input points consumed by :attr:`pair_fn`."""
        return self.ndim

    def get_cutoff(self):
        """Compact-support radius beyond which the kernel is exactly
        zero (``inf``: no compact support)."""
        return np.inf

    # ------------------------------------------------------------------
    # Evaluation API (george-compatible: numpy in, numpy out)
    # ------------------------------------------------------------------

    def parse_points(self, x):
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[1] != self.input_ndim:
            raise ValueError("Dimension mismatch")
        return x

    @property
    def theta(self):
        """Full parameter vector as a CPU float64 tensor."""
        return torch.as_tensor(self.parameter_vector, dtype=torch.float64)

    def _points(self, x1, x2, device, dtype=torch.float64):
        """``(theta, x1, x2)`` as ``dtype`` tensors on ``device``; ``x2``
        defaults to ``x1``."""
        like = {"device": torch.device(device), "dtype": dtype}
        a = torch.as_tensor(self.parse_points(x1)).to(**like)
        b = a if x2 is None else torch.as_tensor(
            self.parse_points(x2)).to(**like)
        return self.theta.to(**like), a, b

    def get_value(self, x1, x2=None, diag=False, nns=None, device="cuda",
                  dtype=torch.float64):
        """The covariance matrix (or its diagonal), evaluated on
        ``device`` in ``dtype`` (default float64) and returned as numpy.

        With ``nns`` (any non-``None`` value, ``x2`` unset), evaluates only
        the pairs within :func:`get_cutoff` of each other and returns a
        ``scipy.sparse.csr_matrix``: ``nns`` may be a ``(nbr_idx,
        row_ptr)`` CSR structure, a ragged per-row listing or a
        rectangular kNN matrix (``-1`` = missing; its symmetrized union
        pattern is used); anything else recomputes the radius
        neighbours."""
        if x2 is None and not diag and nns is not None:
            from ..neighbors import knn_matrix_to_csr, normalize_nns

            x = self.parse_points(x1)
            nns = normalize_nns(nns)
            if isinstance(nns, tuple):
                pass
            elif np.ndim(nns) == 2 and len(nns) == len(x):
                nns = knn_matrix_to_csr(nns, len(x))
            else:
                nns = None
            return self._get_value_sparse(x, nns, device, dtype)
        theta, a, b = self._points(x1, x2, device, dtype)
        with torch.no_grad():
            if diag:
                return self.pair_fn(theta, a, b).cpu().numpy()
            return self.gram(theta, a, b).cpu().numpy()

    def _neighbor_csr(self, x):
        """CSR neighbour structure within the compact-support cutoff (kept
        in ``nns_saved`` for :func:`get_gradient`)."""
        from ..neighbors import radius_neighbors_csr

        nbr_idx, row_ptr = radius_neighbors_csr(x, float(self.get_cutoff()))
        self.nns_saved = (nbr_idx, row_ptr)
        return nbr_idx, row_ptr

    def neighbors_to_csr(self, neighbors):
        """Flatten a ragged per-row neighbour listing (e.g. the output of
        ``BallTree.query_radius``) into ``(nbr_idx, row_ptr)`` CSR index
        arrays."""
        from ..neighbors import ragged_to_csr

        return ragged_to_csr(neighbors)

    def _pair_tensors(self, x, nns, device, dtype):
        """The stored pairs of a CSR structure as device tensors: ``(theta,
        x[rows], x[cols], (nbr_idx, row_ptr))``."""
        nbr_idx, row_ptr = (np.asarray(a, dtype=np.int64) for a in nns)
        theta, xt, _ = self._points(x, None, device, dtype)
        rows = torch.repeat_interleave(
            torch.arange(len(x), device=xt.device),
            torch.as_tensor(np.diff(row_ptr), device=xt.device))
        cols = torch.as_tensor(nbr_idx, device=xt.device)
        return theta, xt[rows], xt[cols], (nbr_idx, row_ptr)

    def _get_value_sparse(self, x, nns=None, device="cuda",
                          dtype=torch.float64):
        """CSR covariance over the pairs of ``nns`` (``(nbr_idx,
        row_ptr)``) or of the radius neighbours; the pairs are evaluated
        on ``device``."""
        from scipy.sparse import csr_matrix

        if nns is not None:
            self.nns_saved = nns
        else:
            nns = self._neighbor_csr(x)
        theta, xa, xb, (nbr_idx, row_ptr) = self._pair_tensors(
            x, nns, device, dtype)
        with torch.no_grad():
            vals = self.pair_fn(theta, xa, xb).cpu().numpy()
        return csr_matrix((vals, nbr_idx, row_ptr), shape=(len(x), len(x)))

    def get_gradient(self, x1, x2=None, include_frozen=False, nns=None,
                     device="cuda", dtype=torch.float64):
        """Hyperparameter gradient, shape ``(n1, n2, n_active)``, evaluated
        on ``device`` in ``dtype`` by forward mode. With ``nns`` (``x2``
        unset): one ``scipy.sparse.csr_matrix`` per active parameter over
        the neighbour structure of the last sparse :func:`get_value` (or
        the radius neighbours)."""
        mask = (
            np.ones(self.full_size, dtype=bool)
            if include_frozen
            else self.unfrozen_mask
        )
        if x2 is None and nns is not None:
            return self._get_gradient_sparse(self.parse_points(x1), mask,
                                             device, dtype)
        theta, a, b = self._points(x1, x2, device, dtype)
        g = torch.func.jacfwd(lambda th: self.gram(th, a, b))(theta)
        return g.detach().cpu().numpy()[:, :, mask]

    def _get_gradient_sparse(self, x, mask, device, dtype):
        from scipy.sparse import csr_matrix

        nns = getattr(self, "nns_saved", None)
        if nns is None:
            nns = self._neighbor_csr(x)
        theta, xa, xb, (nbr_idx, row_ptr) = self._pair_tensors(
            x, nns, device, dtype)
        g = torch.func.jacfwd(lambda th: self.pair_fn(th, xa, xb))(theta)
        g = g.detach().cpu().numpy()
        return [
            csr_matrix((g[:, i], nbr_idx, row_ptr), shape=(len(x), len(x)))
            for i in range(g.shape[1])
            if mask[i]
        ]

    def _x_gradient(self, which, x1, x2, device):
        """``d k(x1_i, x2_j) / d x{which}`` for every pair, shape ``(n1,
        n2, d)``: reverse mode through the sum of the pairwise block, in
        which each entry depends on its own copy of the point only."""
        theta, a, b = self._points(x1, x2, device)
        shape = (a.shape[0], b.shape[0], a.shape[1])
        a = a[:, None, :].expand(shape).contiguous()
        b = b[None, :, :].expand(shape).contiguous()
        if which == 1:
            g = torch.func.grad(lambda p: self.pair_fn(theta, p, b).sum())(a)
        else:
            g = torch.func.grad(lambda p: self.pair_fn(theta, a, p).sum())(b)
        return g.detach().cpu().numpy()

    def get_x1_gradient(self, x1, x2=None, device="cuda"):
        """Gradient of every entry in its first point, ``(n1, n2, d)``."""
        return self._x_gradient(1, x1, x2, device)

    def get_x2_gradient(self, x1, x2=None, device="cuda"):
        """Gradient of every entry in its second point, ``(n1, n2, d)``."""
        return self._x_gradient(2, x1, x2, device)

    # ------------------------------------------------------------------
    # Finite-difference self-tests: thin wrappers over one central-
    # difference probe, as in the JAX package
    # ------------------------------------------------------------------

    def _fd_probe(self, value_fn, read, write, coord, eps):
        """Central difference of ``value_fn()`` as one coordinate of a
        mutable state vector is nudged: ``read()`` returns the state,
        ``write(state)`` installs it, ``coord`` indexes into it."""
        state = read()
        pinned = state[coord]
        samples = {}
        for signed in (eps, -eps):
            state[coord] = pinned + signed
            write(state)
            samples[signed] = value_fn()
        state[coord] = pinned
        write(state)
        return (samples[eps] - samples[-eps]) / (2.0 * eps)

    def test_gradient(self, x1, x2=None, eps=1.32e-6, device="cuda",
                      **kwargs):
        """Check :func:`get_gradient` against central differences of
        :func:`get_value` (``np.allclose`` options in ``kwargs``)."""
        names = self.get_parameter_names()
        analytic = self.get_gradient(x1, x2=x2, device=device)
        value_fn = lambda: self.get_value(x1, x2=x2, device=device)
        for i in range(len(names)):
            fd = self._fd_probe(
                value_fn,
                self.get_parameter_vector, self.set_parameter_vector,
                (i,), eps,
            )
            if not np.allclose(analytic[:, :, i], fd, **kwargs):
                worst = np.max(np.abs(analytic[:, :, i] - fd))
                raise AssertionError(
                    "analytic gradient of %s w.r.t. %r deviates from the "
                    "central difference by up to %g"
                    % (type(self).__name__, names[i], worst)
                )

    def _test_x_gradient(self, which, x1, x2, eps, device, kwargs):
        kwargs.setdefault("atol", 0.5 * eps)
        x1 = np.array(x1, dtype=np.float64)
        analytic = self._x_gradient(which, x1, x2, device)
        # a missing x2 is a copy: only the probed point array moves
        x2 = np.array(x1 if x2 is None else x2, dtype=np.float64)
        xp = x1 if which == 1 else x2
        value_fn = lambda: self.get_value(x1, x2=x2, device=device)
        for i in range(len(xp)):
            for k in range(self.ndim):
                # the point arrays are nudged in place, so the install
                # callback has nothing to do
                fd = self._fd_probe(
                    value_fn, lambda: xp, lambda _: None, (i, k), eps
                )
                got = analytic[i, :, k] if which == 1 else analytic[:, i, k]
                ref = fd[i] if which == 1 else fd[:, i]
                assert np.allclose(got, ref, **kwargs), (
                    "input-gradient mismatch at point %d axis %d" % (i, k)
                )

    def test_x1_gradient(self, x1, x2=None, eps=1.32e-6, device="cuda",
                         **kwargs):
        self._test_x_gradient(1, x1, x2, eps, device, kwargs)

    def test_x2_gradient(self, x1, x2=None, eps=1.32e-6, device="cuda",
                         **kwargs):
        self._test_x_gradient(2, x1, x2, eps, device, kwargs)


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

class _operator(Kernel):
    is_kernel = False
    kernel_type = -1

    def __init__(self, k1, k2):
        if k1.ndim != k2.ndim:
            raise ValueError("Dimension mismatch")
        self.ndim = k1.ndim
        self._dirty = True
        ModelSet.__init__(self, [("k1", k1), ("k2", k2)])

    @property
    def k1(self):
        return self.models["k1"]

    @property
    def k2(self):
        return self.models["k2"]

    @property
    def dirty(self):
        return self._dirty or self.k1.dirty or self.k2.dirty

    @dirty.setter
    def dirty(self, v):
        self._dirty = v
        self.k1.dirty = False
        self.k2.dirty = False

    def _compile_binary(self, combine):
        f1 = self.k1.pair_fn
        f2 = self.k2.pair_fn
        n1 = self.k1.full_size

        def pair(theta, x1, x2):
            return combine(
                f1(theta[:n1], x1, x2), f2(theta[n1:], x1, x2)
            )

        return pair


class Sum(_operator):
    is_kernel = False
    operator_type = 0

    def _compile(self):
        return self._compile_binary(lambda a, b: a + b)

    def get_cutoff(self):
        return max(self.k1.get_cutoff(), self.k2.get_cutoff())

    def __repr__(self):
        return "{0} + {1}".format(self.k1, self.k2)


class Product(_operator):
    is_kernel = False
    operator_type = 1

    def _compile(self):
        return self._compile_binary(lambda a, b: a * b)

    def get_cutoff(self):
        # a product with a compactly supported factor is compactly
        # supported
        return min(self.k1.get_cutoff(), self.k2.get_cutoff())

    def __repr__(self):
        return "{0} * {1}".format(self.k1, self.k2)


# ---------------------------------------------------------------------------
# Stationary / non-stationary bases used by the generated kernel classes
# ---------------------------------------------------------------------------

class StationaryKernel(Kernel):
    """A kernel of the form ``k(r2)`` over a metric squared distance.

    The metric (isotropic / axis-aligned / general) contributes trailing
    parameters; optional per-axis ``block`` bounds zero the kernel outside a
    box.
    """

    stationary = True
    _value_fn = None  # staticmethod: f(r2, *base_params, *constants)

    def _init_stationary(self, base, metric, block):
        self.ndim = metric.ndim
        self.axes = metric.axes
        self.block = block
        ModelSet.__init__(self, [(None, base), ("metric", metric)])
        self.dirty = True

    @property
    def block(self):
        if not self.blocked:
            return None
        return list(zip(self.min_block, self.max_block))

    @block.setter
    def block(self, block):
        if block is None:
            self.blocked = False
            self.min_block = -np.inf + np.zeros(len(self.axes))
            self.max_block = np.inf + np.zeros(len(self.axes))
        else:
            block = np.atleast_2d(block)
            if block.shape != (len(self.axes), 2):
                raise ValueError("dimension mismatch in block specification")
            self.blocked = True
            self.min_block, self.max_block = map(np.array, zip(*block))
        self.__dict__.pop("_pair_fn", None)

    def _compile(self):
        metric = self.models["metric"]
        nb = len(self._base_param_names)
        consts = tuple(
            float(getattr(self, c)) for c in self._constant_names
        )
        r2_fn = metric_r2_fn(metric.metric_type, metric.axes, self.ndim)
        value_fn = self._value_fn
        blocked = bool(self.blocked)
        axes_s = tuple(int(a) for a in self.axes)
        bounds_s = tuple(
            (float(lo), float(hi))
            for lo, hi in zip(self.min_block, self.max_block)
        )

        def pair(theta, x1, x2):
            base = tuple(theta[i] for i in range(nb))
            r2 = r2_fn(theta[nb:], x1, x2)
            val = value_fn(r2, *base, *consts)
            if blocked:
                inside = True
                for a, (lo, hi) in zip(axes_s, bounds_s):
                    inside = (
                        inside
                        & (x1[..., a] >= lo) & (x1[..., a] <= hi)
                        & (x2[..., a] >= lo) & (x2[..., a] <= hi)
                    )
                val = torch.where(inside, val, 0.0)
            return val

        return pair

    def __repr__(self):
        base = self.models[None]
        params = [
            "{0}={1}".format(k, getattr(base, k))
            for k in base.parameter_names
        ]
        params += [
            "metric={0}".format(repr(self.metric)),
            "block={0}".format(repr(self.block)),
        ]
        return "{0}({1})".format(self.__class__.__name__, ", ".join(params))


class NonStationaryKernel(Kernel):
    """A kernel evaluated per input axis and summed over the selected
    axes."""

    stationary = False
    _value_fn = None  # staticmethod: f(x1, x2, *base_params, *constants)

    def _init_nonstationary(self, base, subspace):
        self.subspace = subspace
        self.ndim = subspace.ndim
        self.axes = subspace.axes
        ModelSet.__init__(self, [(None, base)])
        self.dirty = True

    def _compile(self):
        axes = tuple(int(a) for a in self.axes)
        nb = len(self._base_param_names)
        consts = tuple(
            float(getattr(self, c)) for c in self._constant_names
        )
        value_fn = self._value_fn

        def pair(theta, x1, x2):
            base = tuple(theta[i] for i in range(nb))
            total = 0.0
            for j in axes:
                total = total + value_fn(
                    x1[..., j], x2[..., j], *base, *consts
                )
            return total

        return pair

    def __repr__(self):
        base = self.models[None]
        params = [
            "{0}={1}".format(k, getattr(base, k))
            for k in base.parameter_names
        ]
        params += [
            "ndim={0}".format(self.ndim),
            "axes={0}".format(repr(self.axes)),
        ]
        return "{0}({1})".format(self.__class__.__name__, ", ".join(params))
