"""fill.pcg_iterations: ``CGResult.iterations`` (the MG-PCG iterations of
every refinement pass) as a mean a call."""


def read(run):
    its = [c["iterations"] for c in run.calls if "iterations" in c]
    return sum(its) / len(its) if its else None
