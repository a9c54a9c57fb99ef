"""One module per entry a traffic mix drives. Each module gives:

* ``draw(rng, cell, count)``: the inputs of ``count`` calls, drawn before
  the window (a list);
* ``make_call(gp, cell)``: ``call(input) -> output``, the timed call, whose
  output is read back to the host before it returns;
* ``finite(output)``: whether an output is a number throughout;
* ``reference(ref, cell, inputs)``: the outputs of the plain reference
  ``ref`` (``reference.gp.BandedGP``) at the same inputs;
* ``gaps(outputs, expected)``: the numbers that decide ``correct``, by name.

``cell`` (``harness.Cell``) holds the configuration, the traffic mix and
the data of the run.
"""
