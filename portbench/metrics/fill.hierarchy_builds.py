"""fill.hierarchy_builds: multigrid hierarchies built a call (the counter
``hierarchy_builds`` of the span ``fill.hierarchy``: 1 on a miss of the
program's mask-keyed cache, 0 on a hit), as a mean a call."""

from portbench import program_spans


def read(run):
    return program_spans.per_call(run, "fill",
                                  program_spans.counter("hierarchy_builds", "fill.hierarchy"))
