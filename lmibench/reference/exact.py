"""Exact nearest neighbours over each query's visited buckets, in plain
float32 PyTorch.

The semantics are those of ``LearnedIndex.search`` over a one-level
index: the MLP's logits order the buckets, a query visits its
``visits`` most probable ones, and the answer is the ``k`` rows of
those buckets with the smallest ``1 - <q, x>``, ``x`` the row as the
store holds it (an int8 row times its scale).  Inserted rows join the
bucket the MLP gives them; deleted rows leave.

Two tolerances say where float32 rounding may decide differently on
two correct implementations, never more:

* ``NAV_TIE``: a bucket whose logit is within this of the last visited
  one may be visited or not, and a row whose two best logits are within
  it may sit in either bucket.  Such buckets and rows are *possible*:
  the answer may hold them, the reference's own answer leaves them out.
* ``DIST_TIE``: two distances within this are a tie.

Everything runs with TF32 off, so float32 products are float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lmibench import inputs

NAV_TIE = 1e-5
DIST_TIE = 1e-5
QUERY_STEP = 32_768


@contextlib.contextmanager
def strict_f32():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


class Reference:
    """The corpus of a configuration and seed, its buckets by the MLP's
    own logits, and the rows that serving inserted."""

    def __init__(self, params: Sequence[Dict[str, np.ndarray]], config: dict, device):
        self.device = torch.device(device)
        self.config = config
        (self.w1, self.bias1), (self.w2, self.bias2) = [
            (torch.as_tensor(p["w"][0], device=self.device),
             torch.as_tensor(p["b"][0], device=self.device)) for p in params]
        self.nb = self.w2.shape[1]
        self.values = self.scales = None
        self.n = 0
        self.ins_rows = torch.zeros((0, config["dim"]), device=self.device)
        self.ins_b1 = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.ins_b2 = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.ins_ids = np.zeros(0, np.int64)
        self._ins_lookup: Optional[torch.Tensor] = None

    # ---- navigation ----
    def logits(self, x: torch.Tensor) -> torch.Tensor:
        with strict_f32():
            return torch.relu(x @ self.w1 + self.bias1) @ self.w2 + self.bias2

    def buckets(self, x: torch.Tensor):
        """A row's bucket and, where its two best logits tie, the other
        one (else -1)."""
        top = torch.topk(self.logits(x), 2, dim=1)
        amb = (top.values[:, 0] - top.values[:, 1]) < NAV_TIE
        return top.indices[:, 0], torch.where(amb, top.indices[:, 1], -1)

    def visits(self, q: torch.Tensor, visits: int):
        """``(definite, possible)`` (Q, n_buckets) masks of the buckets a
        query visits."""
        lg = self.logits(q)
        vals = torch.sort(lg, dim=1, descending=True).values
        v = min(visits, self.nb)
        last = vals[:, v - 1 : v]
        nxt = vals[:, v : v + 1] if v < self.nb else torch.full_like(last, -torch.inf)
        possible = lg >= last - NAV_TIE
        definite = lg > nxt + NAV_TIE
        return definite, possible

    # ---- the corpus ----
    def load_corpus(self, seed: int) -> None:
        """Draw the corpus again from the seed (``inputs``) and bucket it."""
        cfg, dev = self.config, self.device
        n, d = cfg["rows"], cfg["dim"]
        int8 = cfg["store"] == "int8"
        self.n = n
        self.values = torch.empty((n, d), dtype=torch.int8 if int8 else torch.float32, device=dev)
        self.scales = torch.empty(n, device=dev) if int8 else None
        b1 = torch.empty(n, dtype=torch.int64, device=dev)
        b2 = torch.empty(n, dtype=torch.int64, device=dev)
        gen = inputs.generator(cfg, seed, dev)
        for s0, x in inputs.corpus_blocks(gen, cfg):
            v, s = inputs.stored_form(x, cfg["store"])
            e = s0 + len(x)
            self.values[s0:e] = v
            if int8:
                self.scales[s0:e] = s
            b1[s0:e], b2[s0:e] = self.buckets(inputs.as_float(v, s))
            del x, v, s
        self.b1, self.b2 = b1, b2
        # the rows each bucket surely holds, bucket by bucket
        key = torch.where(b2 >= 0, self.nb, b1)
        self.order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=self.nb + 1)[: self.nb]
        self.starts = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])

    def rows_f32(self, idx: torch.Tensor) -> torch.Tensor:
        """Base rows (0-based) as float32, as the store holds them."""
        return inputs.as_float(self.values[idx], None if self.scales is None else self.scales[idx])

    def bucket_sizes(self) -> np.ndarray:
        """Rows a bucket, by the reference's buckets of the base rows."""
        return torch.bincount(self.b1, minlength=self.nb).cpu().numpy()

    def add_inserted(self, rows: torch.Tensor, ids: np.ndarray) -> None:
        """Rows that serving inserted (float32, as the client sent them)
        with the ids the server acknowledged."""
        rows = rows.to(self.device, torch.float32)
        b1, b2 = self.buckets(rows)
        v, s = inputs.stored_form(rows, self.config["store"])
        self.ins_rows = torch.cat([self.ins_rows, inputs.as_float(v, s)])
        self.ins_b1 = torch.cat([self.ins_b1, b1])
        self.ins_b2 = torch.cat([self.ins_b2, b2])
        self.ins_ids = np.concatenate([self.ins_ids, np.asarray(ids, np.int64)])
        self._ins_lookup = None

    def _lookup(self) -> torch.Tensor:
        """Inserted id - n - 1 -> position among the inserted rows, -1 none."""
        if self._ins_lookup is None:
            span = int(self.ins_ids.max()) - self.n if len(self.ins_ids) else 0
            lut = np.full(max(span, 0) + 1, -1, np.int64)
            ok = self.ins_ids > self.n
            lut[self.ins_ids[ok] - self.n - 1] = np.nonzero(ok)[0]
            self._ins_lookup = torch.as_tensor(lut, device=self.device)
        return self._ins_lookup

    def resolve(self, ids: torch.Tensor):
        """1-based ids -> ``(known, base position or -1, inserted position
        or -1)``."""
        ids = ids.long()
        base = (ids >= 1) & (ids <= self.n)
        lut = self._lookup()
        off = ids - self.n - 1
        in_lut = (off >= 0) & (off < lut.numel())
        ins = torch.where(in_lut, lut[off.clamp(0, max(lut.numel() - 1, 0))], -1)
        ins = torch.where(base, -1, ins)
        return base | (ins >= 0), torch.where(base, ids - 1, -1), ins

    def row_buckets(self, ids: torch.Tensor):
        """``(bucket, other bucket or -1)`` of each id (-1, -1 unknown)."""
        known, bpos, ipos = self.resolve(ids)
        b1 = torch.where(bpos >= 0, self.b1[bpos.clamp_min(0)],
                         self.ins_b1[ipos.clamp_min(0)] if len(self.ins_ids) else -1)
        b2 = torch.where(bpos >= 0, self.b2[bpos.clamp_min(0)],
                         self.ins_b2[ipos.clamp_min(0)] if len(self.ins_ids) else -1)
        return torch.where(known, b1, -1), torch.where(known, b2, -1)

    def distances(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(Q, k) exact ``1 - <q, x>`` of each id's row; inf where the id
        names no row."""
        out = torch.full(ids.shape, torch.inf, device=self.device)
        for s0 in range(0, q.shape[0], QUERY_STEP):
            i = ids[s0 : s0 + QUERY_STEP]
            known, bpos, ipos = self.resolve(i)
            x = self.rows_f32(bpos.clamp_min(0).reshape(-1)).reshape(*i.shape, -1)
            if len(self.ins_ids):
                xi = self.ins_rows[ipos.clamp_min(0).reshape(-1)].reshape(*i.shape, -1)
                x = torch.where((ipos >= 0)[..., None], xi, x)
            with strict_f32():
                sims = torch.bmm(x, q[s0 : s0 + QUERY_STEP, :, None])[..., 0]
            out[s0 : s0 + QUERY_STEP] = torch.where(known, 1.0 - sims, torch.inf)
        return out

    def topk_base(self, q: torch.Tensor, definite: torch.Tensor, k: int):
        """Exact ``(dists, ids)`` (Q, k) over the base rows that surely lie
        in each query's surely visited buckets, ascending."""
        Q = q.shape[0]
        slots = int(definite.sum(1).max()) if Q else 0
        cand_d = torch.full((Q, max(slots, 1) * k), torch.inf, device=self.device)
        cand_i = torch.zeros((Q, max(slots, 1) * k), dtype=torch.int64, device=self.device)
        filled = torch.zeros(Q, dtype=torch.int64, device=self.device)
        for b in range(self.nb):
            qi = torch.nonzero(definite[:, b])[:, 0]
            lo, hi = int(self.starts[b]), int(self.starts[b + 1])
            if qi.numel() == 0 or hi == lo:
                continue
            rows = self.order[lo:hi]
            x = self.rows_f32(rows)
            kk = min(k, hi - lo)
            for s0 in range(0, qi.numel(), QUERY_STEP):
                qs = qi[s0 : s0 + QUERY_STEP]
                with strict_f32():
                    sims = q[qs] @ x.T
                top = torch.topk(sims, kk, dim=1)
                col = (filled[qs] * k)[:, None] + torch.arange(kk, device=self.device)
                cand_d[qs[:, None], col] = 1.0 - top.values
                cand_i[qs[:, None], col] = rows[top.indices] + 1
            filled[qi] += 1
            del x
        best = torch.topk(cand_d, k, dim=1, largest=False)
        return best.values, torch.gather(cand_i, 1, best.indices)
