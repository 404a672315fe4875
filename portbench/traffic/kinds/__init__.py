"""Kinds of traffic mix, one file each, found by ``generate.py`` by the
mix's ``kind``: ``make(mix, model, starts, rng, seconds) -> dict``."""
