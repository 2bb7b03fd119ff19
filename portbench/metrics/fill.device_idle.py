"""fill.device_idle: 1 - the union of the device's operation intervals
over the traced window, in percent (torch.profiler); the fill cells' half
of one quantity, split by the end-to-end metric it moves."""

from portbench.trace import idle_percent as read  # noqa: F401
