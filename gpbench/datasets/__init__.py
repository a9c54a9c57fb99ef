"""One module per dataset recipe a configuration names: ``make(rng,
**params)``, given the run's dataset generator, returns ``x`` (sorted,
``(n,)``), ``y``, ``yerr`` (per point) and the domain ``(low, high)`` of
``x``, as float64 numpy."""
