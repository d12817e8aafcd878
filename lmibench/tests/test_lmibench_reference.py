"""The plain reference against the port's plain CPU path at a tiny size:
the same corpus, queries and weights give the same answers."""

import numpy as np
import pytest
import torch

from lmibench import harness
from lmibench.reference.exact import Reference

from lmibench.tests import tiny


@pytest.mark.parametrize("store", ["int8", "float32"])
def test_reference_answers_as_the_port(store):
    cfg, traffic = tiny.config(store), tiny.traffic("batch")
    cell = harness.Cell(cfg, traffic, 77, "cpu", lambda m: None)
    d, ids, _ = cell.index.search(None, cell.pool, None, cell.pool, None, store=cell.store,
                                  **cell.knobs({}))
    params, pool = cell.params, cell.pool
    cell.free()
    ref = Reference(params, cfg, "cpu")
    ref.load_corpus(77)
    q = torch.as_tensor(pool)
    definite, possible = ref.visits(q, traffic["visits"])
    assert bool((definite.sum(1) == traffic["visits"]).all())  # no ties at this seed
    ref_d, ref_i = ref.topk_base(q, definite, traffic["k"])
    # the same rows, but where the port holds a row whose bucket rounding
    # leaves open (the reference leaves it out) or two rows tie in float32:
    # there the port is never farther at any rank
    differ = ref_i.numpy() != ids.astype(np.int64)
    assert differ.mean() < 1e-3
    assert np.all(d <= ref_d.numpy() + 1e-6)
    exact = ref.distances(q, torch.as_tensor(ids.astype(np.int64)))
    assert np.allclose(exact.numpy(), d, rtol=0, atol=1e-6)


@pytest.mark.parametrize("workload,store", [("laion10m-int8.batch", "int8"),
                                            ("laion10m-f32.batch", "float32"),
                                            ("laion10m-int8.serve", "int8")])
def test_a_sound_run_is_correct(workload, store):
    result, numbers, limits = tiny.run(workload, store)
    assert result["correct"], numbers
    assert numbers["bad_ids"] == numbers["unanswered"] == numbers["probe_miss"] == 0
    assert numbers["dist_err"] <= 1e-6 and numbers["miss_share"] == 0.0
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
