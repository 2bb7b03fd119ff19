"""fill.host_surface_s: the public surface's host work inside the program,
the spans ``fill.unknowns`` (the unknown set), ``fill.exactness_check`` (the
float32 cast and its exactness test) and ``fill.scatter_back`` (the copy of
the stack and the scatter of the solved values), summed a call, as a mean a
call."""

from portbench import program_spans


def read(run):
    return program_spans.per_call(run, "fill", program_spans.seconds(
        "fill.unknowns", "fill.exactness_check", "fill.scatter_back"))
