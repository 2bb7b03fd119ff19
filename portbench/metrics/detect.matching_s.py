"""detect.matching_s: the StageTimer stage "cloud-shadow matching", seconds
as a mean a call."""


def read(run):
    got = [c["stages"].get("cloud-shadow matching", 0.0) for c in run.calls if "stages" in c]
    return sum(got) / len(got) if got else None
