"""The benchmark's plain reference of DIAL's closed loop.

A frozen copy of the semantics the benchmark checks, in plain PyTorch,
independent of the program under test: it imports nothing of the
program.  :mod:`.engine` is the PFS engine tick and the workload demand
over a flat fleet, :mod:`.tuning` the tuning tick (probe, snapshot,
gates, features, forest scores, Algorithm 1, write-back) and
:mod:`.loop` the interval that joins them.

Every segment sum adds its entries in entry order from ``+0.0``, the
ordered float64 sum the configurations state (``index_add_`` on the
CPU, or one add a column of a padded gather on the card).  The engine
and the tuning tick run on the device they are given.  ``dtype`` selects the
engine's float type: float64 is the reference, float32 the control.
"""
