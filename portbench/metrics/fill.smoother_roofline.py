"""fill.smoother_roofline: the smoothers' (kernels 1 and 2, jacobi_kernel in
csrc/jacobi.cu) least time at their mask bound over their summed device
time, in percent.

The bound is the frozen byte model of ``portbench/roofline.py`` on every
level of each call's mask, over the V-cycles the call ran: one a PCG
iteration and one a refinement pass (the preconditioning of its first
residual). The run fails when the launches that model counts differ from
the launches the profiler saw."""

import torch

from portbench import roofline, trace


def _is_smoother(name: str) -> bool:
    return "jacobi_kernel" in name and "jacobi_v2" not in name


def read(run):
    if not run.device_events:
        return None
    ref = run.ctx.reference()
    state = run.state
    c = state.images.shape[0]
    per_scene = {}
    nbytes = flops = launches = 0
    for call in run.calls:
        if call["failed"]:
            continue
        k = call["scene"]
        if k not in per_scene:
            um = ref.unknowns(torch.as_tensor(state.invalid[k], device=run.ctx.device))
            per_scene[k] = roofline.vcycle_smoother_work(um, c)
        b, f, n = per_scene[k]
        cycles = call["iterations"] + call["passes"]
        nbytes += b * cycles
        flops += f * cycles
        launches += n * cycles
    measured, seen = trace.seconds_by_name(run.device_events, _is_smoother)
    if seen != launches:
        raise RuntimeError(f"fill.smoother_roofline: the model counts {launches} smoother "
                           f"launches, the profiler saw {seen}")
    if measured <= 0:
        return None
    kind = torch.cuda.get_device_name(run.ctx.device)
    return 100.0 * roofline.bound_s(nbytes, flops, kind) / measured
