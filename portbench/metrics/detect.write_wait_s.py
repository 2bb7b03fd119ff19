"""detect.write_wait_s: the StageTimer stage "write shadow masks (wait)"
(the calling thread's wait, at the end of a call, for the mask writes still
running on the writer threads), seconds as a mean a call."""


def read(run):
    got = [c["stages"].get("write shadow masks (wait)", 0.0) for c in run.calls if "stages" in c]
    return sum(got) / len(got) if got else None
