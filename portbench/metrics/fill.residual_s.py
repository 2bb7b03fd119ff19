"""fill.residual_s: the refinement passes' residuals, the spans
``fill.residual`` of ``models.fill._fused_refine_solve`` (each pass's
residual and the fetch of its norms, the pass's one sync), summed a call,
as a mean a call; None where the program records no such span. In the
Laplace fill it times kernel 5 and the norm, in the Poisson blend the
torch cascade of the guidance residual."""

from portbench import program_spans


def read(run):
    got = program_spans.in_window(run)
    if not got or not any(r.name == "fill.residual" for r in got):
        return None
    return program_spans.per_call(run, "fill", program_spans.seconds("fill.residual"))
