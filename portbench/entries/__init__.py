"""Program entries, one module each, named by a traffic mix's ``entry``.

Each module has ``setup(run)`` (build the program's state from the
seed's inputs and weights and warm up every shape the mix uses),
``window(run, deadline)`` (the timed work), ``release(run)`` (free the
program), ``judge(run)`` (the comparison with the plain reference:
``[(name, value, limit, passed)]``), ``end_to_end(run)`` (the measured
end-to-end metrics) and ``work(run)`` (what the per-layer metrics count,
in a traced run)."""
