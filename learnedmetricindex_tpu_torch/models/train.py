"""MLP training, many node models at once (counterpart of
``learnedmetricindex_tpu/models/train.py``).

All sibling node models of a tree level train together as one stacked
set of parameters (weights ``(M, in, out)``, biases ``(M, out)``), each
on its own row segment, until every model's own predictions cover all
of its valid classes (the reference's convergence rule, which
guarantees that no bucket is empty).  Models that are covered are
frozen while the rest train on.

* **Gradients** come from autograd; the loss is the per-model cross
  entropy with masked classes at ``NEG_INF`` and optional per-class
  weights (``torch.nn.CrossEntropyLoss(weight=)`` semantics).
* **Adam** is written out, not ``torch.optim.Adam``: it reproduces
  ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, bias correction)
  under the JAX package's per-model select, so a frozen model keeps its
  parameters *and* both moments, while the step count — one scalar for
  all models — advances on every step.
* **Batches** are drawn outside the step (:func:`batch_indices`), from
  a ``torch.Generator`` on the training device; :func:`train_step`
  takes the indices, so the same indices can go through both packages.
  ``update_rule="minibatch"`` draws uniform with-replacement batches per
  model; ``"reference"`` makes one Adam step per epoch from a batch of
  the epoch's runt length, as the reference's loop effectively does.

**Grouping.**  Rows are never moved: slot ``s`` of the grouped layout
is row ``slot_rows[s]`` of the original data (-1 = padding), and every
tile of ``tile`` slots belongs to one model.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch import native
from learnedmetricindex_tpu_torch.models.mlp import StackedMLP
from learnedmetricindex_tpu_torch.ops.select import largest_k

NEG_INF = -1e9
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


class GroupedData(NamedTuple):
    """Index-only grouped layout over an unmoved data tensor: model ``m``
    owns slots ``seg_starts[m] .. seg_starts[m] + seg_lens[m]`` (padded to
    a tile boundary; tile ``t`` belongs to model ``tile_model[t]``)."""

    x: torch.Tensor  # (n_rows, d), original order
    slot_rows: torch.Tensor  # (total_slots,) int64, -1 = pad
    labels: torch.Tensor  # (total_slots,) int64, -1 = pad
    tile_model: torch.Tensor  # (n_tiles,) int64
    seg_starts: torch.Tensor  # (n_models,) int64, tile-aligned
    seg_lens: torch.Tensor  # (n_models,) int64, true lengths
    slot_rows_np: np.ndarray  # host copy of slot_rows
    tile: int
    x_scales: Optional[torch.Tensor] = None  # (n_rows,) f32, int8 corpora

    def scatter_to_rows(self, slot_values: np.ndarray, n_rows: int, fill=0) -> np.ndarray:
        """Per-slot values back in original row order."""
        out = np.full(n_rows, fill, dtype=np.asarray(slot_values).dtype)
        valid = self.slot_rows_np >= 0
        out[self.slot_rows_np[valid]] = np.asarray(slot_values)[valid]
        return out


def group_rows(
    data,
    group_ids: np.ndarray,
    n_groups: int,
    labels: Optional[np.ndarray] = None,
    tile: int = 4096,
    dtype=torch.float32,
    scales=None,
    *,
    device=None,
) -> GroupedData:
    """The grouped layout (a counting sort of row *indices* through
    ``native``).  A tensor ``data`` stays where it is and as it is; host
    data is uploaded once to ``device`` as ``dtype``."""
    group_ids = np.asarray(group_ids)
    counts = native.bincount(group_ids, n_groups)
    padded_counts = np.maximum(-(-counts // tile) * tile, tile)
    seg_starts = np.concatenate([[0], np.cumsum(padded_counts)[:-1]])
    total = int(padded_counts.sum())
    slot_rows, lab = native.fill_slots(group_ids, seg_starts, total, labels=labels)
    if lab is None:
        lab = np.full(total, -1, dtype=np.int32)
    tile_model = np.repeat(np.arange(n_groups), padded_counts // tile)
    if isinstance(data, torch.Tensor):
        x = data
    else:
        if device is None:
            raise ValueError("group_rows needs a device for host data")
        x = torch.as_tensor(np.asarray(data), device=device).to(dtype)
    dev = x.device
    if scales is not None:
        scales = torch.as_tensor(scales).to(device=dev, dtype=torch.float32)
    return GroupedData(
        x=x,
        slot_rows=torch.as_tensor(slot_rows, device=dev).long(),
        labels=torch.as_tensor(lab, device=dev).long(),
        tile_model=torch.as_tensor(tile_model, device=dev).long(),
        seg_starts=torch.as_tensor(seg_starts, device=dev).long(),
        seg_lens=torch.as_tensor(counts, device=dev).long(),
        slot_rows_np=slot_rows,
        tile=tile,
        x_scales=scales,
    )


class AdamState(NamedTuple):
    """``optax.adam``'s state: the shared step count and per-leaf moments."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: List[torch.Tensor]) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


def forward(params: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Each model on its own batch: ``params`` ``[w0, b0, w1, b1, ...]``
    with weights (M, in, out), ``x`` (M, B, d) → logits (M, B, C)."""
    h = x
    n = len(params) // 2
    for i in range(n):
        h = torch.bmm(h, params[2 * i]) + params[2 * i + 1][:, None, :]
        if i < n - 1:
            h = torch.relu(h)
    return h


def _weighted_mean_ce(ce: torch.Tensor, yb: torch.Tensor, class_weight) -> torch.Tensor:
    """Per-model reduction of per-sample cross entropies (M, B): the
    mean over the batch (pad rows, label -1, count 0), or with (M, C)
    weights ``Σ w[y]·ce / Σ w[y]`` as ``CrossEntropyLoss(weight=)``."""
    if class_weight is None:
        return torch.where(yb >= 0, ce, 0.0).mean(1)
    w = torch.gather(class_weight, 1, yb.clamp_min(0))
    w = torch.where(yb >= 0, w, 0.0)
    return (w * ce).sum(1) / torch.clamp_min(w.sum(1), 1e-12)


def _masked_logits(params, xb, class_mask):
    return torch.where(class_mask[:, None, :], forward(params, xb), NEG_INF)


def batch_rows(grouped: GroupedData, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot indices (M, B) → the batch's f32 rows (M, B, d) and labels
    (M, B), -1 for slots without a row."""
    rows = grouped.slot_rows[idx]
    r = rows.clamp_min(0)
    xb = grouped.x[r].float()
    if grouped.x_scales is not None:
        xb = xb * grouped.x_scales[r][:, :, None]
    return xb, torch.where(rows >= 0, grouped.labels[idx], -1)


def train_step(
    params: List[torch.Tensor],
    state: AdamState,
    xb: torch.Tensor,
    yb: torch.Tensor,
    class_mask: torch.Tensor,
    active: torch.Tensor,
    class_weight: Optional[torch.Tensor],
    *,
    lr: float,
    all_active: bool,
    runt: Optional[torch.Tensor] = None,
) -> Tuple[List[torch.Tensor], AdamState, torch.Tensor]:
    """One Adam update of every active model on its batch ``xb`` (M, B,
    d), ``yb`` (M, B) (-1 = no row).  ``active`` (M,) bool on the
    device; ``all_active`` says every entry is True, which skips the
    per-model select (it would take every new value) without reading
    ``active`` back.  ``runt`` (M,): the reference update rule's batch
    length per model (labels past it are dropped and the unweighted mean
    runs over it).  Returns the new parameters and state and the
    per-model losses."""
    M, B = yb.shape
    if runt is not None:
        yb = torch.where(torch.arange(B, device=yb.device)[None, :] < runt[:, None], yb, -1)
        if class_weight is None:
            class_weight = torch.ones(class_mask.shape, device=xb.device)
    leaves = [p.detach().requires_grad_(True) for p in params]
    logits = _masked_logits(leaves, xb, class_mask)
    ce = -torch.gather(torch.log_softmax(logits, dim=-1), 2, yb.clamp_min(0)[:, :, None])[:, :, 0]
    per_model = _weighted_mean_ce(ce, yb, class_weight)
    grads = torch.autograd.grad((per_model * active).sum(), leaves)

    count = state.count + 1
    # optax's bias corrections: decay ** count in f32
    bc1 = 1.0 - float(np.float32(B1) ** np.float32(count))
    bc2 = 1.0 - float(np.float32(B2) ** np.float32(count))
    mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1), torch._foreach_mul(state.mu, B1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2),
        torch._foreach_mul(state.nu, B2),
    )
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), EPS)
    upd = torch._foreach_mul(torch._foreach_div(torch._foreach_div(mu, bc1), den), -lr)
    new = torch._foreach_add([p.detach() for p in params], upd)
    if not all_active:  # frozen models keep parameters and both moments
        def sel(n, o):
            return [torch.where(active.reshape((M,) + (1,) * (a.dim() - 1)), a, b)
                    for a, b in zip(n, o)]

        new, mu, nu = sel(new, params), sel(mu, state.mu), sel(nu, state.nu)
    return new, AdamState(count, mu, nu), per_model.detach()


def batch_indices(
    generator: torch.Generator,
    seg_starts: torch.Tensor,
    seg_lens: torch.Tensor,
    *,
    batch_size: int,
    steps: int,
    ref_dynamics: bool = False,
) -> torch.Tensor:
    """(steps, M, B) slot indices: per model uniform draws with
    replacement from its segment.  With ``ref_dynamics`` a segment that
    fits one batch takes all of its rows, in order, every step."""
    M = seg_starts.shape[0]
    dev = seg_starts.device
    lens = seg_lens.clamp_min(1)
    u = torch.rand((steps, M, batch_size), generator=generator, device=dev, dtype=torch.float64)
    draw = torch.minimum((u * lens[None, :, None]).long(), lens[None, :, None] - 1)
    idx = seg_starts[None, :, None] + draw
    if ref_dynamics:
        seq = seg_starts[:, None] + torch.arange(batch_size, device=dev)[None, :] % lens[:, None]
        idx = torch.where((seg_lens <= batch_size)[None, :, None], seq[None], idx)
    return idx


def _run_epochs(
    params, state, generator, grouped, class_mask, active, class_weight, *,
    batch_size: int, steps: int, lr: float, ref_dynamics: bool = False, block: int = 256,
):
    """``steps`` updates (epochs under ``ref_dynamics``) on every active
    model; indices are drawn ``block`` steps at a time."""
    runt = None
    if ref_dynamics:
        runt = (grouped.seg_lens.clamp_min(1) - 1) % batch_size + 1
    all_active = bool(np.all(active))
    active = torch.as_tensor(np.asarray(active, bool), device=grouped.x.device)
    losses = None
    for s0 in range(0, steps, block):
        idx_block = batch_indices(
            generator, grouped.seg_starts, grouped.seg_lens, batch_size=batch_size,
            steps=min(block, steps - s0), ref_dynamics=ref_dynamics,
        )
        for idx in idx_block:
            xb, yb = batch_rows(grouped, idx)
            params, state, losses = train_step(
                params, state, xb, yb, class_mask, active, class_weight, lr=lr,
                all_active=all_active, runt=runt,
            )
    return params, state, losses


@torch.no_grad()
def _predict_own_tiles(params, grouped: GroupedData, class_mask, block_bytes: int = 256 << 20):
    """(total_slots,) argmax prediction of each slot under its own model
    (pad slots read row 0), a block of tiles at a time."""
    tile = grouped.tile
    n_tiles = grouped.tile_model.shape[0]
    srt = grouped.slot_rows.reshape(n_tiles, tile)
    d = grouped.x.shape[1]
    per = max(1, block_bytes // (tile * d * 4))
    out = []
    for t0 in range(0, n_tiles, per):
        m = grouped.tile_model[t0 : t0 + per]
        r = srt[t0 : t0 + per].clamp_min(0)
        x = grouped.x[r].float()
        if grouped.x_scales is not None:
            x = x * grouped.x_scales[r][:, :, None]
        logits = _masked_logits([p[m] for p in params], x, class_mask[m])
        out.append(torch.argmax(logits, dim=-1))
    return torch.cat(out).reshape(-1)


@torch.no_grad()
def _coverage(preds, labels, tile_model, class_mask) -> torch.Tensor:
    """covered[m]: every valid class of model m is among its own
    predictions (the reference's convergence rule)."""
    M, C = class_mask.shape
    tile = preds.shape[0] // tile_model.shape[0]
    model_of_row = torch.repeat_interleave(tile_model, tile)
    counts = torch.zeros((M, C), dtype=torch.int64, device=preds.device)
    counts.index_put_((model_of_row, preds.long()), (labels >= 0).long(), accumulate=True)
    return ((counts > 0) | ~class_mask).all(1)


class StackedNodeTrainer:
    """Trains ``n_models`` same-shape MLPs on ``device``, each on its own
    row segment, until every model's predictions cover its valid
    classes.  Parameters come from a CPU generator seeded with ``seed``
    (the same on every device); batches from a generator on ``device``."""

    def __init__(
        self,
        n_models: int,
        input_dim: int,
        n_classes: int,
        model_type: str = "MLP",
        lr: float = 0.01,
        batch_size: int = 256,
        seed: int = 2023,
        update_rule: str = "minibatch",
        *,
        device,
    ):
        if update_rule not in ("minibatch", "reference"):
            raise ValueError(
                f"update_rule must be 'minibatch' or 'reference', got {update_rule!r}"
            )
        self.device = torch.device(device)
        self.n_models = n_models
        self.n_classes = n_classes
        self.batch_size = batch_size
        self.lr = lr
        self.update_rule = update_rule
        mlp = StackedMLP.init(n_models, model_type, input_dim, n_classes,
                              generator=torch.Generator().manual_seed(seed), device=self.device)
        self.params = [t for w, b in zip(mlp.weights, mlp.biases) for t in (w.data, b.data)]
        self.opt_state = adam_init(self.params)
        self.class_mask = torch.ones((n_models, n_classes), dtype=torch.bool, device=self.device)
        self.class_weight: Optional[torch.Tensor] = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def mlp(self) -> StackedMLP:
        """The trained models, as the index holds them."""
        return StackedMLP([p.detach().clone() for p in self.params[0::2]],
                          [p.detach().clone() for p in self.params[1::2]])

    def set_class_mask(self, mask) -> None:
        """(n_models, n_classes) bool — False marks classes a node does not use."""
        self.class_mask = torch.as_tensor(np.asarray(mask, bool), device=self.device)

    def set_class_weight(self, weight) -> None:
        """(n_models, n_classes) f32 per-class loss weights; None = unweighted."""
        self.class_weight = (
            None if weight is None
            else torch.as_tensor(np.asarray(weight, np.float32), device=self.device)
        )

    def run(self, grouped: GroupedData, steps: int, active: np.ndarray) -> torch.Tensor:
        """``steps`` updates (epochs for the reference rule) of the active
        models; returns the last per-model losses."""
        self.params, self.opt_state, losses = _run_epochs(
            self.params, self.opt_state, self.generator, grouped, self.class_mask, active,
            self.class_weight, batch_size=self.batch_size, steps=steps, lr=self.lr,
            ref_dynamics=self.update_rule == "reference",
        )
        return losses

    def fit(self, grouped: GroupedData, epochs: int, max_rounds: int = 1000) -> Tuple[np.ndarray, int]:
        """Train until covered → (per-slot predictions over the grouped
        layout, rounds run).  Raises after ``max_rounds`` rounds without
        full coverage."""
        max_len = max(int(grouped.seg_lens.max()), 1)
        if self.update_rule == "reference":
            steps = epochs  # one update per epoch
        else:
            steps = max(1, -(-max_len // self.batch_size)) * epochs
        active = np.ones(self.n_models, bool)
        rounds = 0
        while True:
            self.run(grouped, steps, active)
            preds = _predict_own_tiles(self.params, grouped, self.class_mask)
            covered = _coverage(preds, grouped.labels, grouped.tile_model, self.class_mask)
            covered = covered.cpu().numpy()
            rounds += 1
            if covered.all():
                break
            if rounds > max_rounds:
                raise RuntimeError(f"The model did not converge after {max_rounds} iterations.")
            active = ~covered
        return preds.cpu().numpy().astype(np.int32), rounds

    def predict_slots(self, grouped: GroupedData) -> np.ndarray:
        """Per-slot argmax under each slot's own model."""
        return _predict_own_tiles(self.params, grouped, self.class_mask).cpu().numpy().astype(np.int32)

    @torch.no_grad()
    def predict_proba_all(self, queries) -> torch.Tensor:
        """All models on the same queries → (n_models, n_queries,
        n_classes) probabilities, masked classes at 0."""
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        logits = self.mlp(q)
        m = self.class_mask[:, None, :]
        return torch.where(m, torch.softmax(torch.where(m, logits, NEG_INF), dim=-1), 0.0)


class NeuralNetwork:
    """One model with the reference's API (``train``/``train_batch``,
    ``predict``, ``predict_proba``), a 1-model :class:`StackedNodeTrainer`."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        lr: float = 0.1,
        model_type: str = "MLP",
        class_weight=None,
        seed: int = 2023,
        batch_size: int = 256,
        *,
        device,
    ):
        self._trainer = StackedNodeTrainer(
            1, input_dim, output_dim, model_type, lr, batch_size, seed, device=device
        )
        if class_weight is not None:
            class_weight = np.asarray(class_weight, np.float32)
            if class_weight.shape != (output_dim,):
                raise ValueError(
                    f"class_weight must have shape ({output_dim},), got {class_weight.shape}"
                )
            self._trainer.set_class_weight(class_weight[None, :])
        self.output_dim = output_dim

    def _x(self, X) -> torch.Tensor:
        return torch.as_tensor(np.asarray(X, np.float32), device=self._trainer.device)

    def train_batch(self, X, y, epochs: int = 5) -> None:
        """One round of ``epochs`` epochs of minibatch Adam (no coverage loop)."""
        t = self._trainer
        grouped = group_rows(np.asarray(X, np.float32), np.zeros(len(X), np.int64), 1,
                             labels=y, tile=4096, device=t.device)
        steps = max(1, -(-int(grouped.seg_lens[0]) // t.batch_size)) * epochs
        t.run(grouped, steps, np.ones(1, bool))

    def train(self, X, y, epochs: int = 5) -> None:
        """Full batch: one Adam step per epoch on the whole dataset."""
        t = self._trainer
        xb = self._x(X)[None]
        yb = torch.as_tensor(np.asarray(y, np.int64), device=t.device)[None]
        for _ in range(epochs):
            t.params, t.opt_state, _ = train_step(
                t.params, t.opt_state, xb, yb, t.class_mask,
                torch.ones(1, dtype=torch.bool, device=t.device), t.class_weight,
                lr=t.lr, all_active=True,
            )

    @torch.no_grad()
    def predict(self, X) -> np.ndarray:
        """Argmax class per row."""
        logits = self._trainer.mlp(self._x(X))[0]
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def predict_proba(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(probabilities sorted descending, their classes) per row."""
        prob = torch.softmax(self._trainer.mlp(self._x(X))[0], dim=-1)
        probs, classes = largest_k(prob, prob.shape[-1])
        return probs.cpu().numpy(), classes.cpu().numpy()


def train_until_covered(
    data,
    labels,
    n_classes: int,
    *,
    model_type: str = "MLP",
    lr: float = 0.01,
    epochs: int = 100,
    batch_size: int = 256,
    seed: int = 2023,
    max_rounds: int = 1000,
    device,
) -> Tuple[StackedNodeTrainer, np.ndarray]:
    """One model trained until its own predictions use every class →
    (trainer, per-row predictions in original row order)."""
    n, d = data.shape
    trainer = StackedNodeTrainer(1, d, n_classes, model_type, lr, batch_size, seed, device=device)
    grouped = group_rows(data, np.zeros(n, np.int64), 1, labels=labels, device=device)
    preds_slots, _ = trainer.fit(grouped, epochs, max_rounds)
    return trainer, grouped.scatter_to_rows(preds_slots, n)
