"""detect.pitfill_roofline: kernel 9's (``directional_pass_kernel``,
csrc/pitfill.cu, the pit fill's directional pass) least time at its byte
bound over its summed device time, in percent.

The bytes are those the pit fill's cycles need. A cycle is four passes
(down, up, left, right) and a pass reads ``orig`` and ``f`` and writes its
output, 12 B a cell of its level, so a ``pitfill.level`` span that ran
``cycles`` cycles over ``cells`` cells needs 48 B x cells x cycles. A budget
queues all its cycles before the host looks at the flag, and those after
the first unchanged one copy their input: their time is counted, their
bytes are not, so the share reads them as waste.

None where kernel 9 did not run, where the program's levels record no
``launches`` (a program older than the counter), or where the launches they
record differ from the launches the profiler saw."""

import torch

from portbench import program_spans, roofline, trace

PASS_BYTES = 12
PASSES_A_CYCLE = 4


def _kind(device) -> str:
    return torch.cuda.get_device_name(device)


def read(run):
    if not run.device_events:
        return None
    seconds, seen = trace.seconds_by_name(run.device_events,
                                          lambda name: "directional_pass_kernel" in name)
    records = program_spans.in_window(run)
    if not seen or seconds <= 0 or not records:
        return None
    levels = [r for r in records if r.name == "pitfill.level"]
    if not levels or any("launches" not in r.counts for r in levels):
        return None
    if sum(r.counts["launches"] for r in levels) != seen:
        return None
    nbytes = PASS_BYTES * PASSES_A_CYCLE * sum(r.counts["cells"] * r.counts["cycles"]
                                               for r in levels)
    return 100.0 * roofline.bound_s(nbytes, 0, _kind(run.ctx.device)) / seconds
