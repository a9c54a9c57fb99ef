"""The system under test, built from a configuration file: the
``george_tpu_torch.GP`` with the configuration's kernel, solver, options and
dtype, on the data of its recipe. Only the package's public names are
used."""

import math

import torch


def build_kernel(spec):
    """The port's kernel object for a kernel spec (see
    ``reference/kernel.py``): ``{"<Name>": {...}}`` is
    ``kernels.<Name>Kernel(**args)``, an argument that is itself a spec
    built first."""
    from george_tpu_torch import kernels

    (key, arg), = spec.items()
    if key == "sum":
        return build_kernel(arg[0]) + build_kernel(arg[1])
    if key == "product":
        return build_kernel(arg[0]) * build_kernel(arg[1])
    if key == "scale":
        return float(arg[0]) * build_kernel(arg[1])
    args = {k: build_kernel(v) if isinstance(v, dict) else v
            for k, v in arg.items()}
    if key == "Constant":
        args = {"log_constant": math.log(args.pop("value")), **args}
    return getattr(kernels, key + "Kernel")(**args)


def build_gp(config, device, solver_inputs=None):
    """An uncomputed ``GP`` for ``config`` on ``device``; ``solver_inputs``
    are further solver options made from the seed (such as probes)."""
    import george_tpu_torch as gtt
    from george_tpu_torch import solvers

    kernel = build_kernel(config["kernel"])
    for name in config["frozen"]:
        kernel.freeze_parameter(name)
    solver = config["solver"]
    return gtt.GP(kernel, solver=getattr(solvers, solver["name"]),
                  white_noise=math.log(config["white_noise"]),
                  device=device, dtype=getattr(torch, config["dtype"]),
                  **solver.get("options", {}), **(solver_inputs or {}))

