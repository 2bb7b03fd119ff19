"""detect.pitfill_kernel_ms: the profiler's device milliseconds of kernel 9
(``directional_pass_kernel``, csrc/pitfill.cu) a call."""

from portbench import trace


def read(run):
    done = [c for c in run.calls if not c["failed"]]
    if not run.device_events or not done:
        return None
    seconds, n = trace.seconds_by_name(run.device_events,
                                       lambda name: "directional_pass_kernel" in name)
    return 1e3 * seconds / len(done) if n else None
