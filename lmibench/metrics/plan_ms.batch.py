"""The scan's plan a call: the port's ``lmi.plan`` spans
(``scan_inputs``: ``build_plan`` with its read of the pair count, the
int8 queries' quantization, the chunk lists' upload), host time summed
over the traced window, mean over its calls."""

from lmibench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "lmi.plan")
