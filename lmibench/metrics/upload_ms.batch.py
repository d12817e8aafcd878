"""The queries' upload a call: the port's ``lmi.upload`` spans
(``LearnedIndex.search``'s ``_as_tensor`` of the host queries), host
time summed over the traced window, mean over its calls."""

from lmibench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "lmi.upload")
