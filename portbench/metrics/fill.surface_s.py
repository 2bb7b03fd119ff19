"""fill.surface_s: a call's wall minus the harness's span around
``models.fill.laplace_fill``, as a mean a call: the public surface's host
work (the float64 stack, the float32 exactness check, the scatter back)."""


def read(run):
    inner = run.spans.get("laplace_fill", [])
    done = [c for c in run.calls if not c["failed"]]
    if not done or len(inner) != len(done):
        return None
    walls = sum(c["end"] - c["start"] for c in done)
    return (walls - sum(inner)) / len(done)
