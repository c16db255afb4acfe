"""Drivers, one module a kind of traffic, found by the ``driver`` a
traffic file names. Each holds a ``Cell(c, seed, device)`` with
``setup()``, ``window(seconds)``, ``tail()``/``units_of()`` (the traced
stretch), ``release()``, ``check(flops)`` and ``control(which)``."""
