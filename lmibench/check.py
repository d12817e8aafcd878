"""What decides ``correct``: the answers of the timed path against the
plain reference (``lmibench.reference``).

Every answer due in the window is compared, once the window has closed
and the port's state is freed.  The numbers, each with a limit of its
own (``lmibench/limits/<workload>.json``):

* ``dist_err``: the widest gap between a returned distance and the
  reference's exact float32 distance of the returned row;
* ``miss_share``: the share of answer slots whose row lies farther than
  the reference's row at that rank (beyond ``DIST_TIE``), the reference
  answering over the rows that surely lie in the query's surely visited
  buckets;
* ``bad_ids``: answer slots that name no row, a row twice, a row in no
  bucket the query may visit, or a row that was not live (inserted
  after the answer, or deleted before the request);
* ``unanswered``: requests that failed or never came (in a closed loop,
  the queries of each failed call);
* ``probe_miss``: inserted rows that a search submitted after the insert
  was acknowledged did not find, and deleted rows that a search
  submitted after the delete was acknowledged still found.

An answer may hold rows whose bucket or liveness rounding or timing
leaves open (the reference's *possible* sets); the reference's own
answer holds only what is sure, so a sound answer is never farther at
any rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from lmibench.reference.exact import DIST_TIE, Reference, strict_f32

NUMBERS = ("dist_err", "miss_share", "bad_ids", "unanswered", "probe_miss")


class Answer:
    """One request's answer: pool rows asked, and what came back."""

    __slots__ = ("qidx", "dists", "ids", "t_submit", "t_done")

    def __init__(self, qidx, dists, ids, t_submit=0.0, t_done=0.0):
        self.qidx, self.dists, self.ids = qidx, dists, ids
        self.t_submit, self.t_done = t_submit, t_done


class Mutations:
    """The host clock around every acknowledged insert and delete."""

    def __init__(self):
        self.inserts: List[tuple] = []  # (t0, t1, ids, first row of the insert pool)
        self.deletes: List[tuple] = []  # (t0, t1, ids)

    def times(self, ids: np.ndarray) -> np.ndarray:
        """(n, 4) insert start, insert end, delete start, delete end of each
        inserted id (inf: never deleted)."""
        pos = {int(i): j for j, i in enumerate(ids)}
        out = np.full((len(ids), 4), np.inf)
        for t0, t1, got, _ in self.inserts:
            for i in got:
                out[pos[int(i)], :2] = (t0, t1)
        for t0, t1, got in self.deletes:
            for i in got:
                out[pos[int(i)], 2:] = (t0, t1)
        return out


def compare(ref: Reference, pool: torch.Tensor, visits: int, k: int, answers: List[Answer],
            muts: Optional[Mutations] = None, probes=(), unanswered: int = 0) -> Dict[str, float]:
    """The numbers over ``answers`` (``pool``: the query pool on the
    reference's device)."""
    dev = ref.device
    definite, possible = ref.visits(pool, visits)
    base_d, _ = ref.topk_base(pool, definite, k)
    qidx = np.concatenate([a.qidx for a in answers]) if answers else np.zeros(0, np.int64)
    out = {"dist_err": 0.0, "miss_share": 0.0, "bad_ids": 0, "unanswered": int(unanswered),
           "probe_miss": 0}
    if len(qidx) == 0:
        return out
    d_port = torch.as_tensor(np.concatenate([a.dists for a in answers]).astype(np.float32),
                             device=dev)
    ids = torch.as_tensor(np.concatenate([a.ids for a in answers]).astype(np.int64), device=dev)
    q_t = torch.as_tensor(qidx, device=dev)
    exact = ref.distances(pool[q_t], ids)
    known = torch.isfinite(exact)
    b1, b2 = ref.row_buckets(ids)
    pv = possible[q_t]
    in_visit = ((b1 >= 0) & torch.gather(pv, 1, b1.clamp_min(0))) | (
        (b2 >= 0) & torch.gather(pv, 1, b2.clamp_min(0)))
    srt = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(known)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1])
    bad = ~known | ~in_visit | dup
    ref_d = base_d[q_t]
    if muts is not None and len(ref.ins_ids):
        t_sub = torch.as_tensor(np.concatenate([np.full(len(a.qidx), a.t_submit) for a in answers]),
                                device=dev)
        t_done = torch.as_tensor(np.concatenate([np.full(len(a.qidx), a.t_done) for a in answers]),
                                 device=dev)
        life = torch.as_tensor(muts.times(ref.ins_ids), device=dev)
        _, _, ipos = ref.resolve(ids)
        lt = life[ipos.clamp_min(0)]
        dead = (lt[..., 0] > t_done[:, None]) | (lt[..., 3] < t_sub[:, None])
        bad |= (ipos >= 0) & dead
        ref_d = _with_inserted(ref, pool, definite, base_d, q_t, t_sub, t_done, life, k)
    slots = ids.numel()
    ok = ~bad
    if ok.any():
        out["dist_err"] = float((d_port - exact).abs()[ok].max())
    out["miss_share"] = float(((exact > ref_d + DIST_TIE) & ok).sum()) / slots
    out["bad_ids"] = int(bad.sum())
    for got, want, found in probes:
        if got is None or (int(got) == int(want)) != found:
            out["probe_miss"] += 1
    return out


def _with_inserted(ref, pool, definite, base_d, q_t, t_sub, t_done, life, k):
    """The reference's answer with the inserted rows that surely lived
    through each request and surely lie in a surely visited bucket."""
    kth = base_d[:, -1]
    sure = ref.ins_b2 < 0
    cand_q, cand_i, cand_d = [], [], []
    step = 4096
    for s0 in range(0, len(ref.ins_ids), step):
        rows = ref.ins_rows[s0 : s0 + step]
        with strict_f32():
            d = 1.0 - pool @ rows.T
        inb = definite[:, ref.ins_b1[s0 : s0 + step]] & sure[s0 : s0 + step][None, :]
        hit = torch.nonzero(inb & (d < kth[:, None] + DIST_TIE))
        cand_q.append(hit[:, 0])
        cand_i.append(hit[:, 1] + s0)
        cand_d.append(d[hit[:, 0], hit[:, 1]])
    cq, ci, cd = torch.cat(cand_q), torch.cat(cand_i), torch.cat(cand_d)
    ref_d = base_d[q_t].clone()
    if cq.numel() == 0:
        return ref_d
    # per answered query, the candidates of its pool row that lived through it
    by_q = {}
    for j, q in enumerate(cq.tolist()):
        by_q.setdefault(q, []).append(j)
    rows_of = torch.nonzero(torch.isin(q_t, cq))[:, 0].tolist()
    life_c = life[ci]
    q_host = q_t.tolist()
    for r in rows_of:
        js = torch.as_tensor(by_q[q_host[r]], device=ref_d.device)
        lt = life_c[js]
        alive = (lt[:, 1] < t_sub[r]) & (lt[:, 2] > t_done[r])
        if alive.any():
            merged = torch.cat([ref_d[r], cd[js][alive]])
            ref_d[r] = torch.sort(merged).values[:k]
    return ref_d
