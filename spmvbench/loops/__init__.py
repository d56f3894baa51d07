"""The closed loops a window drives, one a module, found by a traffic
mix's ``loop`` key.  Each has ``make(port, h, a, cfg, traffic, seed,
device)``, whose object offers:

* ``unit(wrap)``: one unit of work (a solve, a block of products) that
  ends in a host read; returns (products, ok, item), where ``item`` holds
  the unit's inputs and the program's outputs for the check.  ``wrap`` is
  None, or in the traced units a function that puts a product callable
  inside a profiler range;
* ``release()``: drops the handle before the reference runs;
* ``reference(ref, item)``: the plain reference's outputs for ``item``'s
  inputs, through ``reference.plain.Csr`` ``ref``;
* ``gaps(out, want)``: the numbers the check compares, by name.
"""
