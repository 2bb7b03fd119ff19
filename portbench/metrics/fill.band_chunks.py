"""fill.band_chunks: the chunks of bands a call solves one after another
(the spans ``fill.chunk`` of ``models.fill.laplace_fill``), as a mean a
call; None where the program records no such span. Each chunk holds its
bands' solver state at once, so more chunks of the same bands hold less
device memory at the peak."""

from portbench import program_spans


def read(run):
    got = program_spans.in_window(run)
    if not got or not any(r.name == "fill.chunk" for r in got):
        return None
    return program_spans.per_call(run, "fill", lambda r: r.name == "fill.chunk")
