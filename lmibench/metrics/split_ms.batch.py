"""The split's host work a call: the port's ``lmi.split`` spans (a CUDA
scan round: the plan's host read, the body, the segment length, the
split and, nested, its launches), host time summed over the traced
window, mean over its calls."""

from lmibench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "lmi.split")
