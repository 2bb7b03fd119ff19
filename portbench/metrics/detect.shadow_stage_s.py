"""detect.shadow_stage_s: the StageTimer stage "potential shadow mask" (the
pit fill and kernel 9 within it), seconds as a mean a call."""


def read(run):
    got = [c["stages"].get("potential shadow mask", 0.0) for c in run.calls if "stages" in c]
    return sum(got) / len(got) if got else None
