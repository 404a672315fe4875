"""Traffic: one general generator (``generate.py``), its kinds of mix
(``kinds/<kind>.py``), its sources of start windows (``starts/<source>.py``)
and the trajectories they draw from (``sources.py``); each mix is a data
file, ``<mix>.json``, of parameters."""
