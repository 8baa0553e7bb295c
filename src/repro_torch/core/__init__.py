"""Analytic floor model and hardware table (copies of ``repro.core``'s
framework-neutral ``floor.py`` and ``hardware.py``)."""
