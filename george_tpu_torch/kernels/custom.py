# -*- coding: utf-8 -*-
"""Hand-written kernels (PyTorch port of ``george_tpu/kernels/custom.py``):
the multi-output ``LCMKernel`` and the compact-support
``WendlandC2Kernel``.

``specs/LCM.yml`` and ``specs/WendlandC2.yml`` declare them with ``kind:
custom``, so the codegen leaves them to this module; they compile to
broadcast pair functions like the generated kernels.
"""

import numpy as np
import torch

from ..modeling import Model, ModelSet
from .base import Kernel, safe_sqrt

__all__ = ["LCMKernel", "WendlandC2Kernel", "BaseLCMKernel",
           "BaseWendlandC2Kernel"]


class BaseWendlandC2Kernel(Model):
    parameter_names = ("log_rc",)


class WendlandC2Kernel(Kernel):
    r"""Wendland C2 compact-support taper applied to a base kernel.

    .. math::

        k(x_i, x_j) = w(r)\,k_\mathrm{base}(x_i, x_j), \qquad
        w(r) = \begin{cases}
            (1 - r/r_c)^4 (4 r/r_c + 1) & r < r_c \\
            0 & r \ge r_c
        \end{cases}

    where :math:`r` is the plain Euclidean distance over the first ``ndim``
    input dimensions. The cutoff radius :math:`r_c` is a fitted parameter
    (in log space) and doubles as the sparsity radius of the sparse solver
    (:meth:`get_cutoff`).

    :param log_rc: the log of the cutoff radius.
    :param kernel_base: the kernel being tapered.

    The parameter names (``log_rc``, then ``kernel_base:...``) are the JAX
    package's, so ``convert.kernel_from_reference`` carries them across.
    """

    kernel_type = 14
    stationary = True
    sparse = True

    def __init__(self, bounds=None, log_rc=0.0, kernel_base=None,
                 ndim=1, axes=None):
        if kernel_base is None:
            raise ValueError("missing required parameter 'kernel_base'")
        self.ndim = ndim
        if axes is None:
            axes = np.arange(ndim, dtype=int)
        self.axes = axes

        kwargs = dict(log_rc=log_rc)
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = BaseWendlandC2Kernel(**kwargs)
        ModelSet.__init__(self, [(None, base), ("kernel_base", kernel_base)])
        self.dirty = True

    def get_cutoff(self):
        return float(np.exp(self.get_parameter_vector(include_frozen=True)[0]))

    def _compile(self):
        child = self.models["kernel_base"]
        child_fn = child.pair_fn
        nc = child.full_size
        ndim = int(self.ndim)

        def pair(theta, x1, x2):
            rc = torch.exp(theta[0])
            d = x1[..., :ndim] - x2[..., :ndim]
            r = safe_sqrt(torch.sum(d * d, dim=-1))
            u = r / rc
            uc = torch.clamp(u, max=1.0)
            taper = torch.where(
                u < 1.0, (1.0 - uc) ** 4 * (4.0 * uc + 1.0), 0.0
            )
            return taper * child_fn(theta[1:1 + nc], x1, x2)

        return pair

    def __repr__(self):
        return "WendlandC2Kernel(log_rc={0}, ndim={1}, kernel_base={2})".format(
            self.get_parameter_vector(include_frozen=True)[0],
            self.ndim,
            repr(self.models["kernel_base"]),
        )


class BaseLCMKernel(Model):
    """Holds the flattened log(B) / log(K) coregionalization parameters."""

    def __init__(self, T, Q, logBK=None):
        self.T = int(T)
        self.Q = int(Q)
        logBK = np.atleast_1d(np.asarray(logBK, dtype=np.float64))
        if len(logBK) != 2 * self.T * self.Q:
            raise ValueError(
                "logBK must have length {0}".format(2 * self.T * self.Q)
            )
        names = [
            "logB_{0}_{1}".format(t, q)
            for t in range(self.T)
            for q in range(self.Q)
        ] + [
            "logK_{0}_{1}".format(t, q)
            for t in range(self.T)
            for q in range(self.Q)
        ]
        self.parameter_names = tuple(names)
        super(BaseLCMKernel, self).__init__(*logBK)


class LCMKernel(Kernel):
    r"""Multi-output linear coregionalization kernel.

    Inputs carry the task id in their **last** coordinate; the first
    ``ndim`` coordinates are the spatial input of the ``Q`` latent child
    kernels:

    .. math::

        K\big((x, t_1), (x', t_2)\big) = \sum_{q=1}^{Q}
            \left[ B_{t_1 q} B_{t_2 q} + \delta_{t_1 t_2} K_{t_1 q} \right]
            k_q(x, x')

    with :math:`B` and :math:`K` stored in log space in the flat parameter
    vector ``logBK`` (the first ``T*Q`` entries log(B) row-major, then
    ``T*Q`` entries log(K)).

    :param logBK: flat array of length ``T*Q*2``.
    :param children: list of ``Q`` child kernels over the spatial dims.
    :param T: number of tasks.
    :param Q: number of latent processes.

    The parameter names (``logB_t_q``, then ``logK_t_q``, then each child's
    under ``child_q:``) are the JAX package's.
    """

    kernel_type = 13
    stationary = True
    block = None
    metric = None

    def __init__(self, logBK, children, T, Q, ndim=1, axes=None):
        if len(children) != Q:
            raise ValueError("expected {0} child kernels".format(Q))
        self.T = int(T)
        self.Q = int(Q)
        self.children = list(children)
        self.ndim = int(ndim)
        if axes is None:
            axes = np.arange(ndim, dtype=int)
        self.axes = axes

        base = BaseLCMKernel(T, Q, logBK=logBK)
        ModelSet.__init__(
            self,
            [(None, base)]
            + [("child_{0}".format(i), c)
               for i, c in enumerate(self.children)],
        )
        self.dirty = True

    @property
    def input_ndim(self):
        # the spatial dims plus the trailing task-id column
        return self.ndim + 1

    @property
    def sort_axes(self):
        """The coordinate axes that carry geometry; the trailing task-id
        column is a label. Hierarchical solvers order and partition on
        these axes only, so tasks interleave spatially and the coarse
        couplings stay low-rank (bounded by ``sum_q rank(B_q) *
        rank(k_q)``); a task-major ordering makes them full-domain
        cross-task kernel matrices."""
        return [int(a) for a in np.atleast_1d(self.axes)]

    def _compile(self):
        T, Q = self.T, self.Q
        TQ = T * Q
        ndim = int(self.ndim)
        child_fns = [c.pair_fn for c in self.children]
        child_sizes = [c.full_size for c in self.children]

        def pair(theta, x1, x2):
            B = torch.exp(theta[:TQ]).reshape(T, Q)
            Kd = torch.exp(theta[TQ:2 * TQ]).reshape(T, Q)
            t1 = x1[..., ndim].long()
            t2 = x2[..., ndim].long()
            xs1 = x1[..., :ndim]
            xs2 = x2[..., :ndim]
            same = t1 == t2
            total = 0.0
            off = 2 * TQ
            for q in range(Q):
                cval = child_fns[q](theta[off:off + child_sizes[q]], xs1, xs2)
                bprod = B[t1, q] * B[t2, q]
                kterm = torch.where(same, Kd[t1, q], 0.0)
                total = total + (bprod + kterm) * cval
                off += child_sizes[q]
            return total

        return pair

    def __repr__(self):
        return (
            "LCMKernel(T={0}, Q={1}, ndim={2}, axes={3}, children={4})".format(
                self.T, self.Q, self.ndim, self.axes,
                [repr(c) for c in self.children],
            )
        )
