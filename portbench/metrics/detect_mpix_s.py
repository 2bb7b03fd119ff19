"""detect_mpix_s: scene pixels of every completed call over the window's
wall time, from the first call's start to the last call's end (host clock)."""


def read(run):
    return run.units() / run.window_s / 1e6
