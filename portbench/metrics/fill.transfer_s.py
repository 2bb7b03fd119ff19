"""fill.transfer_s: the solve's transfers, the spans ``fill.upload`` (the
mask and each chunk of bands to the device) and ``fill.fetch`` (the solved
values back), summed a call, as a mean a call."""

from portbench import program_spans


def read(run):
    return program_spans.per_call(run, "fill", program_spans.seconds("fill.upload", "fill.fetch"))
