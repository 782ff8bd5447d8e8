"""Hand-written CUDA kernels of the port, each beside its plain version.

``LAUNCHES`` counts kernel launches by name.  A wrapper adds one where
it launches its kernel and nowhere else (a CPU tensor runs the plain
version and counts nothing), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()
