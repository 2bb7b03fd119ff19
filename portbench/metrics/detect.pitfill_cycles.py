"""detect.pitfill_cycles: the pit fill's directional cycles a call (kernel
9's work: the counter ``cycles`` of every ``pitfill.level`` span), as a mean
a call."""

from portbench import program_spans


def read(run):
    return program_spans.per_call(run, "detect",
                                  program_spans.counter("cycles", "pitfill.level"))
