"""detect.sweep_kernel_ms: the profiler's device milliseconds of kernel 11
(``similarity_sweep_kernel``, csrc/sweep.cu, the matching's similarity
sweep) a call. None where no such kernel ran."""

from portbench import trace


def read(run):
    done = [c for c in run.calls if not c["failed"]]
    if not run.device_events or not done:
        return None
    seconds, n = trace.seconds_by_name(run.device_events,
                                       lambda name: "similarity_sweep_kernel" in name)
    return 1e3 * seconds / len(done) if n else None
