"""setup_s: from the start of the process to the window's start: imports,
the kernels' load (their build at a checkout's first run), the scenes'
generation and the warm-up call (host clock)."""


def read(run):
    return run.setup_s
