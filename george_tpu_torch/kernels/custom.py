# -*- coding: utf-8 -*-
"""Hand-written kernels (PyTorch port of ``george_tpu/kernels/custom.py``):
the compact-support ``WendlandC2Kernel``.

``specs/WendlandC2.yml`` declares it with ``kind: custom``, so the codegen
leaves it to this module; it compiles to a broadcast pair function like the
generated kernels. The multi-output ``LCMKernel`` of the same JAX module is
not ported yet (it needs the hierarchical solver's ``sort_axes``
handling).
"""

import numpy as np
import torch

from ..modeling import Model, ModelSet
from .base import Kernel, safe_sqrt

__all__ = ["WendlandC2Kernel", "BaseWendlandC2Kernel"]


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
