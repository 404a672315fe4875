"""Sources of start windows, one file each, found by ``generate.py`` by
the mix's ``start.source``: a class ``Source(spec, model, rng)``."""
