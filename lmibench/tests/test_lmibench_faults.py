"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run (set-up, window, reference, result
line) on the CPU at a tiny size, the look for a card skipped, with one
fault planted in the port: half of a search's queries left out, an
answer altered where it is produced, an insert or a delete that leaves
the state as it was.  The cells have no exchange between chips.
"""

import numpy as np
import pytest
import torch

from learnedmetricindex_tpu_torch.index import index as index_mod
from learnedmetricindex_tpu_torch.index.mutation import DynamicIndex

from lmibench.tests import tiny

SEARCH_CELLS = [("laion10m-int8.batch", "int8"), ("laion10m-f32.batch", "float32"),
                ("laion10m-int8.serve", "int8")]


def _broken_scan(monkeypatch, alter):
    real = index_mod.scan_buckets_device

    def scan(*a, **kw):
        dists, ids = real(*a, **kw)
        return alter(dists.clone(), ids.clone())
    monkeypatch.setattr(index_mod, "scan_buckets_device", scan)


def half_left_out(dists, ids):
    h = ids.shape[0] // 2
    dists[h:], ids[h:] = torch.inf, 0
    return dists, ids


def answer_altered(dists, ids):
    ids[:, 0] = torch.where(ids[:, 0] > 1, ids[:, 0] - 1, ids[:, 0] + 1)
    return dists, ids


def order_broken(dists, ids):
    return dists, torch.flip(ids, dims=[1])


@pytest.mark.parametrize("fault", [half_left_out, answer_altered, order_broken],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload,store", SEARCH_CELLS)
def test_a_broken_search_is_not_correct(monkeypatch, workload, store, fault):
    _broken_scan(monkeypatch, fault)
    result, numbers, limits = tiny.run(workload, store)
    assert not result["correct"], numbers
    assert any(numbers[n] > limits[n] for n in numbers)


def test_an_insert_that_changes_nothing_is_not_correct(monkeypatch):
    def insert(self, vectors, object_ids=None):
        ids = np.arange(self.next_id, self.next_id + len(vectors), dtype=np.int64)
        self.next_id += len(vectors)  # acknowledged, and the store left as it was
        return ids
    monkeypatch.setattr(DynamicIndex, "insert", insert)
    result, numbers, _ = tiny.run("laion10m-int8.serve")
    assert not result["correct"] and numbers["probe_miss"] > 0, numbers


def test_a_delete_that_changes_nothing_is_not_correct(monkeypatch):
    monkeypatch.setattr(DynamicIndex, "delete", lambda self, ids: len(ids))
    result, numbers, _ = tiny.run("laion10m-int8.serve")
    assert not result["correct"] and numbers["probe_miss"] > 0, numbers


def test_a_search_that_never_answers_is_not_correct(monkeypatch):
    def fail(*a, **kw):
        raise RuntimeError("planted fault")
    monkeypatch.setattr(index_mod, "scan_buckets_device", fail)
    result, numbers, _ = tiny.run("laion10m-int8.batch", seconds=0.2)
    assert not result["correct"] and numbers["unanswered"] > 0
    assert result["failed"] > 0
