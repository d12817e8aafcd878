"""100M-row rehearsal of the port's sharded layout (the counterpart of
tests/test_scale_rehearsal.py) for the 4×H100 deployment: the real
sharded-store metadata for 100M rows over four shards (the true bucket
sizes, id grid and per-shard CSR from ``shard_store``), with mock d = 8
int8 slabs, here over ``["cpu"] * 4``.  It asserts the headroom the
768-d deployment relies on:

* each shard's slots fit int32 (the CUDA scan kernel's slot arithmetic
  and the id grid are int32);
* padding wastes under 5% of the slots;
* a card's bytes at d = 768 int8 (slabs + id + scale) stay under 70 GiB
  of the H100's 80 GB, leaving room for queries and working space;
* each shard's scan inputs for 10k queries visiting 4 buckets are built
  in under 5 s in all;
* a 64-query ``sharded_search`` equals exact kNN over each query's
  visited buckets.
"""

import os
import time

import numpy as np
import pytest
import torch

from learnedmetricindex_tpu_torch.index.bucket_store import scan_inputs
from learnedmetricindex_tpu_torch.parallel import shard_store, sharded_search

torch.set_num_threads(2)

N = 100_000_000
N_BUCKETS = 1200  # the flagship's 120 buckets per 10M rows, at 100M
CHUNK = 2048
D_MOCK = 8
SHARDS = 4
CARD_BUDGET = 70 * 2**30


@pytest.fixture(scope="module")
def layout():
    """The true-scale bucket-size distribution and a mock d = 8 corpus."""
    if os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES") < 2**34:
        pytest.skip("needs ~16 GB free host RAM for the 100M id grid")
    rng = np.random.default_rng(2023)
    w = rng.lognormal(0.0, 0.4, N_BUCKETS)  # the measured k-means bucket spread
    counts = np.floor(w / w.sum() * N).astype(np.int64)
    counts[0] += N - counts.sum()
    bucket_of_row = np.repeat(np.arange(N_BUCKETS, dtype=np.int32), counts)
    data = rng.integers(-127, 128, (N, D_MOCK), dtype=np.int8)
    return counts, bucket_of_row, data


def test_100m_four_shard_layout_and_search(layout):
    counts, bucket_of_row, data = layout
    t0 = time.perf_counter()
    sharded = shard_store(data, bucket_of_row, N_BUCKETS, ["cpu"] * SHARDS, chunk=CHUNK)
    t_shard = time.perf_counter() - t0
    assert all(s.chunk_data.dtype == torch.int8 for s in sharded.shards)

    # ---- headroom of the 768-d deployment, from this layout ----
    slots = [s.n_chunks * CHUNK for s in sharded.shards]
    assert max(slots) < 2**31, "a shard's slots must fit int32"
    pad_waste = sum(slots) / N - 1.0
    assert pad_waste < 0.05, f"padding waste {pad_waste:.1%} (budget 5%)"
    per_card = max(slots) * (768 + 4 + 4)  # int8 slabs + id + scale
    assert per_card < CARD_BUDGET, f"{per_card / 2**30:.1f} GiB a card (budget 70 GiB)"
    assert sum(int(s.bucket_sizes.sum()) for s in sharded.shards) == N

    # ---- each shard's scan inputs at the flagship query load ----
    rng = np.random.default_rng(7)
    Q_PLAN, V = 10_000, 4
    order_plan = np.stack([rng.choice(N_BUCKETS, V, replace=False) for _ in range(Q_PLAN)])
    queries_plan = torch.as_tensor(rng.normal(size=(Q_PLAN, D_MOCK)).astype(np.float32))
    t0 = time.perf_counter()
    n_pairs = 0
    for i, shard in enumerate(sharded.shards):
        local = np.where(sharded.bucket_device[order_plan] == i,
                         sharded.bucket_local[order_plan], -1)
        plan, _ = scan_inputs(shard, queries_plan, torch.as_tensor(local), 128, "bf16")
        n_pairs += plan.n_pairs
    t_plan = time.perf_counter() - t0
    assert t_plan < 5.0, f"the shards' scan inputs took {t_plan:.1f} s at 100M shapes"
    assert n_pairs >= -(-Q_PLAN * V // 128)

    # ---- one search against each query's visited-bucket oracle ----
    Q = 64
    queries = rng.normal(size=(Q, D_MOCK)).astype(np.float32)
    order = np.stack([rng.choice(N_BUCKETS, V, replace=False) for _ in range(Q)])
    t0 = time.perf_counter()
    # query tiles of 8: the plain version scans whole tiles, and no result
    # depends on the tile (the CUDA kernel's is 128)
    dists, ids = sharded_search(sharded, queries, order, k=10, qtile=8)
    t_search = time.perf_counter() - t0
    assert ids.shape == (Q, 10) and (ids > 0).all() and (ids <= N).all()
    starts = np.concatenate([[0], np.cumsum(counts)])
    for qi in range(0, Q, 16):
        rows = np.concatenate([np.arange(starts[b], starts[b + 1]) for b in order[qi]])
        d_or = 1.0 - data[rows].astype(np.float32) @ queries[qi]
        best = np.argsort(d_or, kind="stable")[:10]
        np.testing.assert_allclose(dists[qi], d_or[best], rtol=1e-5, atol=1e-5)
        untied = np.diff(d_or[best]) > 1e-6  # ids match wherever distances are untied
        mask = np.concatenate([[True], untied]) & np.concatenate([untied, [True]])
        np.testing.assert_array_equal(ids[qi][mask], rows[best][mask] + 1)
    print(f"\n100M rehearsal over {SHARDS} shards: shard_store {t_shard:.1f} s, scan inputs "
          f"{t_plan * 1e3:.0f} ms ({n_pairs} pairs), search({Q} queries) {t_search:.1f} s; "
          f"{max(slots)} slots on the widest shard -> {per_card / 2**30:.2f} GiB a card at "
          f"d=768 int8, padding waste {pad_waste:.2%}")
