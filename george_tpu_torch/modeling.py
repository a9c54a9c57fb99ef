# -*- coding: utf-8 -*-
"""Named-parameter modeling protocol (PyTorch port of
``george_tpu/modeling.py``).

Ordered parameter vectors with names, freeze/thaw masks, bounds that induce
a uniform ``log_prior``, nested composition via :class:`ModelSet` with
``name:param`` paths, and a finite-difference default ``compute_gradient``.

The protocol is numpy-only host metadata, identical to the JAX package's.
Only the pure ``value_fn`` hooks of :class:`ConstantModel` and
:class:`CallableModel` differ: they take and return ``torch`` tensors, so
the GP's fused likelihood can differentiate through them with autograd.
"""

from collections import OrderedDict
from itertools import chain

import numpy as np

__all__ = ["Model", "ModelSet", "ConstantModel", "CallableModel"]


class Model(object):
    """Base class for the modeling protocol.

    Subclasses declare ``parameter_names`` (a tuple of strings) and implement
    :func:`get_value`.  Parameters are passed positionally or by keyword::

        class Line(Model):
            parameter_names = ("m", "b")
            def get_value(self, x):
                return self.m * x + self.b

    Args:
        *args: parameter values in ``parameter_names`` order.
        bounds: optional dict (name -> (lo, hi)) or list of (lo, hi) pairs of
            length ``full_size``; ``None`` endpoints mean unbounded.
        **kwargs: parameter values by name.
    """

    parameter_names = tuple()

    def __init__(self, *args, **kwargs):
        bounds = kwargs.pop("bounds", None)
        quiet = kwargs.pop("quiet", False)
        names = self.parameter_names
        # Snapshot the names (class- or instance-level) so attribute-style
        # parameter access works even for models with dynamic names.
        self.__dict__["_pnames"] = tuple(names)

        if args:
            if len(args) != len(names):
                raise ValueError(
                    "expected {0} arguments but got {1}".format(
                        len(names), len(args)
                    )
                )
            if kwargs:
                raise ValueError(
                    "parameters must be fully specified by arguments or "
                    "keyword arguments, not both"
                )
            values = list(args)
        else:
            values = []
            for name in names:
                if kwargs.get(name) is None:
                    raise ValueError("missing parameter '{0}'".format(name))
                values.append(kwargs.pop(name))
            if kwargs:
                raise ValueError(
                    "unrecognized parameter(s) '{0}'".format(list(kwargs))
                )

        self._vector = np.asarray(values, dtype=np.float64)
        self.unfrozen_mask = np.ones(len(names), dtype=bool)
        self.dirty = True
        self.parameter_bounds = self._parse_bounds(bounds)

        if not quiet and not np.isfinite(self.log_prior()):
            raise ValueError("non-finite log prior value")

    def _parse_bounds(self, bounds):
        n = len(self.parameter_names)
        if bounds is None:
            return [(None, None)] * n
        if hasattr(bounds, "get"):
            out = [bounds.get(name, (None, None)) for name in self.parameter_names]
        else:
            out = list(bounds)
        if len(out) != n:
            raise ValueError(
                "the number of bounds must equal the number of parameters"
            )
        for b in out:
            if len(b) != 2:
                raise ValueError(
                    "the bounds for each parameter must have the format "
                    "'(min, max)'"
                )
        return out

    # -- value / gradient ---------------------------------------------------

    def get_value(self, *args, **kwargs):
        """Evaluate the model at the current parameters (override me)."""
        raise NotImplementedError("overloaded by subclasses")

    def value_fn(self, theta, x):
        """Pure evaluation over an explicit parameter vector.

        Implemented by models that participate in the fused GP likelihood
        path (autograd gradients): ``theta`` is the model's full parameter
        vector as a ``torch`` tensor, ``x`` a tensor of inputs, and the
        result must be computed with ``torch`` ops only.  Models without an
        implementation still work through the host-side ``get_value`` API
        but fall back to host gradients in the GP.
        """
        raise NotImplementedError(
            "{0} does not implement the pure value_fn protocol".format(
                type(self).__name__
            )
        )

    @property
    def traceable(self):
        """Whether this model implements the pure :func:`value_fn` protocol."""
        return (
            type(self).value_fn is not Model.value_fn
        )

    def compute_gradient(self, *args, **kwargs):
        """Gradient of :func:`get_value` w.r.t. the full parameter vector.

        Default: first-order forward finite differences, shape
        ``(full_size,) + value.shape`` (matches the reference's FD fallback,
        ``modeling.py:113-134``).  Subclasses should override with analytic or
        autodiff gradients.
        """
        eps = 1.254e-5
        theta0 = self.get_parameter_vector()
        base = np.asarray(self.get_value(*args, **kwargs), dtype=np.float64)

        def value_at(theta):
            self.set_parameter_vector(theta)
            try:
                return np.asarray(self.get_value(*args, **kwargs))
            finally:
                self.set_parameter_vector(theta0)

        rows = [
            (value_at(theta0 + eps * basis) - base) / eps
            for basis in np.eye(len(theta0))
        ]
        return np.stack(rows) if rows else np.empty((0,) + base.shape)

    def get_gradient(self, *args, **kwargs):
        include_frozen = kwargs.pop("include_frozen", False)
        g = self.compute_gradient(*args, **kwargs)
        if include_frozen:
            return g
        return g[self.unfrozen_mask]

    # -- vector plumbing ----------------------------------------------------

    def __len__(self):
        return self.vector_size

    def _get_name(self, name_or_index):
        try:
            int(name_or_index)
        except (TypeError, ValueError):
            return name_or_index
        return self.get_parameter_names()[int(name_or_index)]

    def __getitem__(self, name_or_index):
        return self.get_parameter(self._get_name(name_or_index))

    def __setitem__(self, name_or_index, value):
        return self.set_parameter(self._get_name(name_or_index), value)

    def __getattr__(self, name):
        # Only called when normal lookup fails; map parameter names to values.
        names = self.__dict__.get("_pnames", ())
        if name in names:
            vec = self.__dict__.get("_vector")
            if vec is not None:
                return float(vec[names.index(name)])
        raise AttributeError(name)

    def __setattr__(self, name, value):
        names = self.__dict__.get("_pnames", ())
        if name in names and "_vector" in self.__dict__:
            self._vector[names.index(name)] = value
            self.__dict__["dirty"] = True
        else:
            object.__setattr__(self, name, value)

    @property
    def full_size(self):
        """Total number of parameters, including frozen ones."""
        return len(self.parameter_names)

    @property
    def vector_size(self):
        """Number of active (unfrozen) parameters."""
        return int(self.unfrozen_mask.sum())

    @property
    def parameter_vector(self):
        """Full parameter vector (including frozen parameters)."""
        return self._vector.copy()

    @parameter_vector.setter
    def parameter_vector(self, v):
        v = np.atleast_1d(np.asarray(v, dtype=np.float64))
        if len(v) != self.full_size:
            raise ValueError("dimension mismatch")
        self._vector = v.copy()
        self.dirty = True

    def get_parameter_dict(self, include_frozen=False):
        return OrderedDict(
            zip(
                self.get_parameter_names(include_frozen=include_frozen),
                self.get_parameter_vector(include_frozen=include_frozen),
            )
        )

    def get_parameter_names(self, include_frozen=False):
        if include_frozen:
            return self.parameter_names
        return tuple(
            p for p, f in zip(self.parameter_names, self.unfrozen_mask) if f
        )

    def get_parameter_bounds(self, include_frozen=False):
        if include_frozen:
            return list(self.parameter_bounds)
        return [
            b for b, f in zip(self.parameter_bounds, self.unfrozen_mask) if f
        ]

    def get_parameter_vector(self, include_frozen=False):
        if include_frozen:
            return self.parameter_vector
        return self.parameter_vector[self.unfrozen_mask]

    def set_parameter_vector(self, vector, include_frozen=False):
        if include_frozen:
            v = np.atleast_1d(np.asarray(vector, dtype=np.float64)).copy()
            if len(v) != self.full_size:
                raise ValueError("dimension mismatch")
        else:
            v = self.parameter_vector
            v[self.unfrozen_mask] = vector
        self.parameter_vector = v
        self.dirty = True

    def check_parameter_vector(self, vector):
        vector0 = np.array(self.get_parameter_vector())
        dirty0 = self.dirty
        self.set_parameter_vector(vector)
        lp = self.log_prior()
        self.set_parameter_vector(vector0)
        self.dirty = dirty0
        return np.isfinite(lp)

    # -- freeze / thaw ------------------------------------------------------

    def freeze_parameter(self, name):
        i = self.get_parameter_names(include_frozen=True).index(name)
        self.unfrozen_mask[i] = False

    def thaw_parameter(self, name):
        i = self.get_parameter_names(include_frozen=True).index(name)
        self.unfrozen_mask[i] = True

    def freeze_all_parameters(self):
        self.unfrozen_mask[:] = False

    def thaw_all_parameters(self):
        self.unfrozen_mask[:] = True

    def get_parameter(self, name):
        i = self.get_parameter_names(include_frozen=True).index(name)
        return self.get_parameter_vector(include_frozen=True)[i]

    def set_parameter(self, name, value):
        i = self.get_parameter_names(include_frozen=True).index(name)
        v = self.get_parameter_vector(include_frozen=True)
        v[i] = value
        self.set_parameter_vector(v, include_frozen=True)

    # -- prior --------------------------------------------------------------

    def log_prior(self):
        """Uniform log-prior inside the bounds, ``-inf`` outside."""
        for p, b in zip(self.parameter_vector, self.parameter_bounds):
            if b[0] is not None and p < b[0]:
                return -np.inf
            if b[1] is not None and p > b[1]:
                return -np.inf
        return 0.0

    @staticmethod
    def parameter_sort(f):
        def func(self, *args, **kwargs):
            values = f(self, *args, **kwargs)
            names = self.get_parameter_names(include_frozen=True)
            ret = [values[k] for k in names]
            if len(ret) and type(ret[0]).__module__ == np.__name__:
                return np.vstack(ret)
            return ret

        return func


class ModelSet(Model):
    """A named composition of :class:`Model` objects.

    Parameter names of submodels are exposed with a ``name:`` prefix; a
    submodel registered under the name ``None`` contributes its names
    unprefixed (reference semantics, ``modeling.py:354-470``).
    """

    def __init__(self, models):
        self.models = OrderedDict(models)

    def __getattr__(self, name):
        models = self.__dict__.get("models")
        if models is not None and name in models:
            return models[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)

    # -- aggregated vector plumbing ----------------------------------------

    @property
    def dirty(self):
        return any(m.dirty for m in self.models.values())

    @dirty.setter
    def dirty(self, value):
        for m in self.models.values():
            m.dirty = value

    @property
    def full_size(self):
        return sum(m.full_size for m in self.models.values())

    @property
    def vector_size(self):
        return sum(m.vector_size for m in self.models.values())

    @property
    def unfrozen_mask(self):
        return np.concatenate(
            [m.unfrozen_mask for m in self.models.values()]
        ) if self.models else np.zeros(0, dtype=bool)

    @property
    def parameter_vector(self):
        if not self.models:
            return np.zeros(0)
        return np.concatenate(
            [m.parameter_vector for m in self.models.values()]
        )

    @parameter_vector.setter
    def parameter_vector(self, v):
        i = 0
        for m in self.models.values():
            n = m.full_size
            if n:
                m.parameter_vector = v[i : i + n]
            i += n

    @property
    def parameter_names(self):
        return tuple(
            chain(
                *(
                    m.parameter_names
                    if name is None
                    else tuple(
                        "{0}:{1}".format(name, p) for p in m.parameter_names
                    )
                    for name, m in self.models.items()
                )
            )
        )

    @property
    def parameter_bounds(self):
        return list(
            chain(*(m.parameter_bounds for m in self.models.values()))
        )

    def _apply_to_parameter(self, func, name, *args):
        comp = name.split(":")
        model_name = comp[0]
        if model_name not in self.models:
            if None in self.models:
                model_name = None
                comp = [None] + comp
            else:
                raise ValueError("unrecognized parameter '{0}'".format(name))
        return getattr(self.models[model_name], func)(
            ":".join(comp[1:]), *args
        )

    def freeze_parameter(self, name):
        self._apply_to_parameter("freeze_parameter", name)

    def thaw_parameter(self, name):
        self._apply_to_parameter("thaw_parameter", name)

    def freeze_all_parameters(self):
        for m in self.models.values():
            m.freeze_all_parameters()

    def thaw_all_parameters(self):
        for m in self.models.values():
            m.thaw_all_parameters()

    def get_parameter(self, name):
        return self._apply_to_parameter("get_parameter", name)

    def set_parameter(self, name, value):
        self.dirty = True
        return self._apply_to_parameter("set_parameter", name, value)

    def log_prior(self):
        lp = 0.0
        for m in self.models.values():
            lp += m.log_prior()
            if not np.isfinite(lp):
                return -np.inf
        return lp


class ConstantModel(Model):
    """A model that evaluates to a single fitted constant everywhere."""

    parameter_names = ("value",)

    def get_value(self, x):
        return self.value + np.zeros(len(x))

    def compute_gradient(self, x):
        return np.ones((1, len(x)))

    def value_fn(self, theta, x):
        import torch

        return theta[0] * torch.ones(
            x.shape[0], dtype=x.dtype, device=x.device
        )


class CallableModel(Model):
    """Wrap a plain callable (and optional gradient callable) as a model.

    If the wrapped function is written with ``torch`` ops it also
    participates in the fused likelihood path (it has no parameters, so
    ``value_fn`` simply applies it).
    """

    parameter_names = tuple()

    def __init__(self, function, gradient=None):
        self.function = function
        self.gradient = gradient
        super(CallableModel, self).__init__()

    def get_value(self, x):
        return self.function(x)

    def compute_gradient(self, x):
        if self.gradient is not None:
            return self.gradient(x)
        return super(CallableModel, self).compute_gradient(x)

    def value_fn(self, theta, x):
        if x.ndim == 2 and x.shape[1] == 1:
            x = x[:, 0]
        return self.function(x)
