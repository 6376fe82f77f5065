"""Traffic substrate: demand trace generators + the Section-IV link simulator.

A verbatim copy of :mod:`repro.traffic` (numpy only): the port imports nothing
of the JAX package, so the same random streams are consumed in the same
order and the two packages build identical scenarios.
"""
from .traces import bursty_trace, constant_trace  # noqa: F401
from .mirage import mirage_trace  # noqa: F401
from .puffer import puffer_trace  # noqa: F401
from . import linksim  # noqa: F401
