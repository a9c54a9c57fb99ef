# -*- coding: utf-8 -*-
"""Kernel DSL compiler, torch target: YAML specs -> generated torch kernel
classes.

Reads the port's own copy of the JAX package's spec files
(``george_tpu_torch/kernels/specs/*.yml``, byte-identical to
``george_tpu/kernels/specs/``; a test guards the copy) and writes
``george_tpu_torch/kernels/generated.py``.
The spec bodies use only ``jnp.exp``/``jnp.sin``/``jnp.cos``, ``safe_sqrt``
and ``M_PI``; the ``jnp.`` namespace maps to ``torch.``, and any other
``jnp`` use is refused so that a new spec cannot slip an untranslated op
into the port. ``kind: custom`` specs (LCM, WendlandC2) are hand-written
modules and are not generated here: the port's are in
``kernels/custom.py``.

The generated file is checked in, so nothing at run time needs ``yaml``;
only this tool imports it, inside :func:`generate` and :func:`check`.

Regenerate with::

    python -m george_tpu_torch.kernels.codegen

and check for drift with ``--check``.
"""

import os
import re
import textwrap

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC_DIR = os.path.join(HERE, "specs")
OUTPUT = os.path.join(HERE, "generated.py")

_ALLOWED_JNP = {"exp", "sin", "cos"}

HEADER = '''\
# -*- coding: utf-8 -*-
"""AUTO-GENERATED by ``python -m george_tpu_torch.kernels.codegen`` — do not
edit.

Kernel classes compiled from the YAML specs in
``george_tpu_torch/kernels/specs/`` (torch target).
"""

import torch

from ..modeling import Model
from ..metrics import Metric, Subspace
from .base import (
    StationaryKernel,
    NonStationaryKernel,
    safe_sqrt,
    M_PI,
)

'''

STATIONARY_INIT = '''\
    def __init__(self{param_args},
                 metric=None, metric_bounds=None, lower=True, block=None,
                 bounds=None, ndim=1, axes=None):
{const_setup}\
        if metric is None:
            raise ValueError("missing required parameter 'metric'")
        metric = Metric(metric, bounds=metric_bounds, ndim=ndim,
                        axes=axes, lower=lower)
        kwargs = dict({param_kwargs})
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _Base{name}(**kwargs)
        self._init_stationary(base, metric, block)
'''

NONSTATIONARY_INIT = '''\
    def __init__(self{param_args},
                 bounds=None, ndim=1, axes=None):
{const_setup}\
        subspace = Subspace(ndim, axes=axes)
        kwargs = dict({param_kwargs})
        if bounds is not None:
            kwargs["bounds"] = bounds
        base = _Base{name}(**kwargs)
        self._init_nonstationary(base, subspace)
'''


def load_specs(safe_load):
    """Parse every spec file with ``safe_load`` (``yaml.safe_load``)."""
    specs = []
    for fn in sorted(os.listdir(SPEC_DIR)):
        if not fn.endswith(".yml"):
            continue
        with open(os.path.join(SPEC_DIR, fn)) as f:
            spec = safe_load(f)
        spec.setdefault("params", [])
        spec.setdefault("constants", [])
        spec.setdefault("reparams", [])
        specs.append(spec)
    specs.sort(key=lambda s: s["kernel_type"])
    return specs


def to_torch(src, name):
    """Map a spec expression from the ``jnp`` namespace to ``torch``."""
    for fn in re.findall(r"\bjnp\.(\w+)", src):
        if fn not in _ALLOWED_JNP:
            raise ValueError(
                "spec {0} uses jnp.{1}, which has no torch mapping here"
                .format(name, fn)
            )
    return re.sub(r"\bjnp\.", "torch.", src)


def render_value_fn(spec):
    """Render the pure value function for a spec."""
    name = spec["name"]
    fn_name = "_value_{0}".format(name.lower().replace("kernel", ""))
    args = ["r2"] if spec["kind"] == "stationary" else ["x1", "x2"]
    args += list(spec["params"]) + list(spec["constants"])
    lines = ["def {0}({1}):".format(fn_name, ", ".join(args))]
    for rp in spec["reparams"]:
        lines.append(
            "    {0} = {1}".format(rp["name"], to_torch(rp["expr"], name))
        )
    body = to_torch(textwrap.dedent(spec["value"]).strip("\n"), name)
    for line in body.split("\n"):
        lines.append("    " + line if line.strip() else "")
    return fn_name, "\n".join(lines) + "\n"


def render_class(spec, fn_name):
    name = spec["name"]
    params = spec["params"]
    constants = spec["constants"]
    doc = textwrap.indent(
        textwrap.dedent(spec.get("doc", name)).strip(), "    "
    )

    out = []
    out.append("class _Base{0}(Model):".format(name))
    out.append(
        "    parameter_names = ({0})".format(
            "".join('"{0}", '.format(p) for p in params)
        )
    )
    out.append("")
    out.append("")
    out.append("Base{0} = _Base{0}".format(name))
    out.append("")
    out.append("")

    parent = (
        "StationaryKernel"
        if spec["kind"] == "stationary"
        else "NonStationaryKernel"
    )
    out.append("class {0}({1}):".format(name, parent))
    out.append('    r"""\n{0}\n    """'.format(doc))
    out.append("")
    out.append("    kernel_type = {0}".format(spec["kernel_type"]))
    out.append(
        "    _base_param_names = ({0})".format(
            "".join('"{0}", '.format(p) for p in params)
        )
    )
    out.append(
        "    _constant_names = ({0})".format(
            "".join('"{0}", '.format(c) for c in constants)
        )
    )
    out.append("    _value_fn = staticmethod({0})".format(fn_name))
    out.append("")

    param_args = "".join(", {0}=None".format(p) for p in params)
    param_args += "".join(", {0}=None".format(c) for c in constants)
    param_kwargs = ", ".join("{0}={0}".format(p) for p in params)
    const_setup = ""
    for c in constants:
        const_setup += (
            "        if {0} is None:\n"
            "            raise ValueError(\"missing required parameter "
            "'{0}'\")\n"
            "        self.{0} = float({0})\n".format(c)
        )
    template = (
        STATIONARY_INIT if spec["kind"] == "stationary" else NONSTATIONARY_INIT
    )
    out.append(
        template.format(
            name=name,
            param_args=param_args,
            param_kwargs=param_kwargs,
            const_setup=const_setup,
        )
    )
    return "\n".join(out)


def render(specs):
    """The full generated source for the non-custom ``specs``."""
    chunks = [HEADER]
    names = []
    for spec in specs:
        if spec["kind"] == "custom":
            continue
        names.append(spec["name"])
        fn_name, fn_src = render_value_fn(spec)
        chunks.append(fn_src)
        chunks.append("")
        chunks.append(render_class(spec, fn_name))
        chunks.append("")
    chunks.insert(
        1, "__all__ = [\n{0}]\n\n".format(
            "".join('    "{0}",\n    "Base{0}",\n'.format(n) for n in names)
        )
    )
    return "\n".join(chunks), names


def _specs():
    import yaml

    return load_specs(yaml.safe_load)


def generate(output=OUTPUT):
    """Write the generated source for the specs to ``output``; returns the
    names of every spec's kernel, the generated ones then the hand-written
    ``custom`` ones."""
    specs = _specs()
    src, names = render(specs)
    with open(output, "w") as f:
        f.write(src)
    return names + [s["name"] for s in specs if s["kind"] == "custom"]


def check():
    """Whether the checked-in ``generated.py`` matches the specs (the
    anti-drift guard)."""
    src, _ = render(_specs())
    with open(OUTPUT) as f:
        return f.read() == src


def main(argv):
    if "--check" in argv:
        if check():
            print("generated sources are in sync with the specs")
            return 0
        print("DRIFT: generated.py does not match the YAML specs; "
              "re-run `python -m george_tpu_torch.kernels.codegen`")
        return 1
    names = generate()
    print("generated {0} kernels -> {1}".format(len(names), OUTPUT))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
