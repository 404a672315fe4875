"""Per-layer metric readers, one file per metric, named as the metric.

Each has ``read(run)``, which returns the metric's value, or None where
the run holds nothing to read (then the line leaves the metric out).
``_common.py`` holds what several readers share."""
