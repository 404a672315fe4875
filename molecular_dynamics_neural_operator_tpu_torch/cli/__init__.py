"""The port's command-line entry points, and the refusal of the flags
whose module is not ported yet: ``train``'s ``--data_parallel`` and
``serve``'s ``--data_mesh``, which wait for the parallel modules."""

# flag -> (refused value test, what brings it), checked before any data
# is read; the items are those of the roadmap's queue A
REFUSED = {
    "data_parallel": (bool, "--data_parallel: the parallel modules are not "
                            "ported yet (queue A item 8)"),
    "data_mesh": (lambda n: n is not None and n > 0,
                  "--data_mesh: the parallel modules are not ported yet "
                  "(queue A item 8)"),
}


def refuse_unported(args) -> None:
    """``SystemExit`` naming the first flag whose module is not ported;
    a flag that the calling CLI does not have is skipped."""
    for name, (refused, why) in REFUSED.items():
        if refused(getattr(args, name, None)):
            raise SystemExit(f"not supported by the PyTorch port: {why}")
