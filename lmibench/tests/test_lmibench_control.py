"""The control comes out not correct: the program with its lower-precision
path on (``rerank=False``: distances and order from the scan's bf16
products) against each cell's limits, while the program itself passes.

On the CPU at a tiny size; marked ``cuda``, the same on the card at a
larger size (its full-size readings come from ``python3 -m
lmibench.control``)."""

import pytest
import torch

from lmibench import control, spec

from lmibench.tests import tiny

CELLS = [("laion10m-int8.batch", "int8"), ("laion10m-f32.batch", "float32"),
         ("laion10m-int8.serve", "int8")]


def _fails(numbers, limits):
    return [n for n in numbers if numbers[n] > limits[n]]


@pytest.mark.parametrize("workload,store", CELLS)
@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_control_fails_program_passes(workload, store, seed):
    traffic = tiny.traffic(tiny.CELLS[workload][1])
    r = control.readings(tiny.config(store), traffic, seed, 0.5, True, "cpu", log=lambda m: None)
    limits = spec.limits(workload)
    assert not _fails(r["program"], limits), r
    assert _fails(r["control"], limits), r


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the scan kernel runs only on the GPU")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("workload,store", CELLS)
def test_control_fails_on_the_card(cuda, workload, store):
    cfg = {**tiny.config(store), "rows": 500_000, "dim": 768, "n_buckets": 120, "hidden": 512,
           "chunk_size": 2048, "clusters": 256}
    traffic = {**spec.traffic(tiny.CELLS[workload][1]), "queries": 2000}
    if traffic["kind"] == "open_loop":
        traffic["rate_per_s"] = 200.0
    r = control.readings(cfg, traffic, 5, 1.0, True, cuda, log=lambda m: None)
    limits = spec.limits(workload)
    assert not _fails(r["program"], limits), r
    assert _fails(r["control"], limits), r
