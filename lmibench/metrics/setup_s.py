"""From process start to the first timed call: imports, kernel loading
(and in a fresh checkout their build), the corpus, index and store, and
the warm-up."""


def read(rec):
    return rec.setup_s
