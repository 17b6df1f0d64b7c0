"""Device idle ms per call in the traced stretch while the host was inside
no ``nr.scene``, ``nr.raster`` or ``nr.backward`` span on any thread, read
as ``unspanned_idle_ms.train`` reads it: the idle that no layer of the
program explains (the harness's loop and its synchronize)."""

from benchmark import harness

read = harness.reader('unspanned_idle_ms.train').read
