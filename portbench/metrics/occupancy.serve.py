"""The server's served steps over the steps it computed in the window
(``RolloutServer.stats``): the share of a segment's streams and steps
that landed in a request, not in padding."""


def read(run):
    computed = run.counters.get("steps_computed", 0)
    if not computed:
        return None
    return 100.0 * run.counters["steps_served"] / computed
