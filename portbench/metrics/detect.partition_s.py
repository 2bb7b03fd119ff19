"""detect.partition_s: the StageTimer stage "cloud partition" (the host
flood, or kernel 10 and the region stats where the mask lies on the card),
seconds as a mean a call."""


def read(run):
    got = [c["stages"].get("cloud partition", 0.0) for c in run.calls if "stages" in c]
    return sum(got) / len(got) if got else None
