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
    data is uploaded once to ``device`` as ``dtype``.  A corpus split over
    the ranks of a world (``parallel.distributed.RankRows``, which
    carries its own scales) stays split: only a trainer over that world
    reads it."""
    group_ids = np.asarray(group_ids)
    counts = native.bincount(group_ids, n_groups)
    padded_counts = np.maximum(-(-counts // tile) * tile, tile)
    seg_starts = np.concatenate([[0], np.cumsum(padded_counts)[:-1]])
    total = int(padded_counts.sum())
    slot_rows, lab = native.fill_slots(group_ids, seg_starts, total, labels=labels)
    if lab is None:
        lab = np.full(total, -1, dtype=np.int32)
    tile_model = np.repeat(np.arange(n_groups), padded_counts // tile)
    from learnedmetricindex_tpu_torch.parallel.distributed import RankRows

    if isinstance(data, (torch.Tensor, RankRows)):
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
    B = yb.shape[1]
    if runt is not None:
        yb = torch.where(torch.arange(B, device=yb.device)[None, :] < runt[:, None], yb, -1)
        if class_weight is None:
            class_weight = torch.ones(class_mask.shape, device=xb.device)
    leaves = [p.detach().requires_grad_(True) for p in params]
    per_model = _weighted_mean_ce(_cross_entropy(leaves, xb, yb, class_mask), yb, class_weight)
    grads = torch.autograd.grad((per_model * active).sum(), leaves)
    new, state = adam_update(params, state, grads, active, lr=lr, all_active=all_active)
    return new, state, per_model.detach()


def _cross_entropy(leaves, xb, yb, class_mask) -> torch.Tensor:
    """Per-sample cross entropy (M, B) of the masked logits (a pad row,
    label -1, reads class 0; callers weight it out)."""
    logits = _masked_logits(leaves, xb, class_mask)
    return -torch.gather(torch.log_softmax(logits, dim=-1), 2, yb.clamp_min(0)[:, :, None])[:, :, 0]


def adam_update(
    params: List[torch.Tensor],
    state: AdamState,
    grads,
    active: torch.Tensor,
    *,
    lr: float,
    all_active: bool,
) -> Tuple[List[torch.Tensor], AdamState]:
    """One ``optax.adam`` step of every active model from ``grads``; a
    frozen model keeps its parameters and both moments."""
    M = params[0].shape[0]
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
    return new, AdamState(count, mu, nu)


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


def _part_rows(grouped: GroupedData, lo: int, hi: int, device) -> GroupedData:
    """The grouped layout of models ``lo .. hi`` alone on ``device``, with
    their segments' rows copied there (pad slots read the segment's
    first row): the same batches and predictions as the whole layout's
    for those models."""
    seg = grouped.seg_starts.cpu().numpy()
    n_slots = grouped.slot_rows.shape[0]
    s0 = int(seg[lo])
    s1 = int(seg[hi]) if hi < len(seg) else n_slots
    rows = grouped.slot_rows[s0:s1]
    r = rows.clamp_min(0)
    local = torch.where(rows >= 0, torch.arange(s1 - s0, device=rows.device), -1)
    return GroupedData(
        x=grouped.x[r].to(device),
        slot_rows=local.to(device),
        labels=grouped.labels[s0:s1].to(device),
        tile_model=(grouped.tile_model[s0 // grouped.tile : s1 // grouped.tile] - lo).to(device),
        seg_starts=(grouped.seg_starts[lo:hi] - s0).to(device),
        seg_lens=grouped.seg_lens[lo:hi].to(device),
        slot_rows_np=np.where(grouped.slot_rows_np[s0:s1] >= 0, np.arange(s1 - s0), -1),
        tile=grouped.tile,
        x_scales=None if grouped.x_scales is None else grouped.x_scales[r].to(device),
    )


class _Part:
    """Expert parallel: models ``lo .. hi``, their parameters and Adam
    state on ``device``."""

    def __init__(self, lo: int, hi: int, device, params: List[torch.Tensor]):
        self.lo, self.hi, self.device = lo, hi, device
        self.params = [p[lo:hi].to(device).clone() for p in params]
        self.state = adam_init(self.params)


class StackedNodeTrainer:
    """Trains ``n_models`` same-shape MLPs on ``device``, each on its own
    row segment, until every model's predictions cover its valid
    classes.  Parameters come from a CPU generator seeded with ``seed``
    (the same on every device); batches from a generator on ``device``.

    ``devices`` (a list, ``devices[0]`` being ``device``; the JAX
    package's ``mesh=``) trains over several devices:

    * **expert parallel**, when ``n_models`` is a multiple of
      ``len(devices)``: device ``i`` holds a contiguous group of models,
      their parameters, Adam state, class mask and weights and a copy of
      their segments' rows, and steps them on its own;
    * **data parallel** otherwise (the level-0 root): the parameters live
      on ``devices[0]`` with a copy on every device; the grouped rows are
      split into contiguous row blocks over the devices
      (``parallel.distributed.split_rows``), each device takes the loss
      over the batch entries whose rows it holds (the host reads how
      many each holds, once a step), the gradients are added on
      ``devices[0]`` in device order and one Adam step is taken there.

    Either way the batch indices are drawn by one generator on
    ``devices[0]``, exactly as the single-device trainer draws them, so
    the two differ only in the order of sums.

    ``devices`` may be a ``parallel.multiprocess.World`` (the grouped
    rows then a ``RankRows``): every level trains data parallel across
    the ranks, each rank drawing the same batches from the same seeded
    generator on its own device, taking the loss over the entries whose
    rows it holds; one ``all_gather`` a step brings every rank's
    gradients, added in rank order, so every rank takes the same Adam
    step, the step of the device list ``["cpu"] * W``.  Each rank
    predicts the slots whose rows it holds and the predictions meet
    through ``to_host_replicated``.  Expert parallelism would move rows
    to each model's rank, so it stays single-process.  The JAX package places
    models over ``"model"`` and rows over the whole 2-D ``("data",
    "model")`` mesh and leaves the step to XLA (its docstring: placement
    does not change the step); the port places them over a 1-D list,
    which changes no step either."""

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
        device=None,
        devices=None,
    ):
        if update_rule not in ("minibatch", "reference"):
            raise ValueError(
                f"update_rule must be 'minibatch' or 'reference', got {update_rule!r}"
            )
        from learnedmetricindex_tpu_torch.parallel.multiprocess import World

        self.world = devices if isinstance(devices, World) else None
        if self.world is not None:
            devices = [self.world.device]
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if device is not None and torch.device(device) != devices[0]:
                raise ValueError(f"device {device} is not devices[0] ({devices[0]})")
            device = devices[0]
        if device is None:
            raise TypeError("StackedNodeTrainer needs a device (or devices)")
        self.device = torch.device(device)
        self.devices = devices if devices is not None and len(devices) > 1 else None
        # what the rows are spread over: the world, the device list, or nothing
        self.spread = self.world if self.world is not None else self.devices
        self.n_models = n_models
        self.n_classes = n_classes
        self.batch_size = batch_size
        self.lr = lr
        self.update_rule = update_rule
        mlp = StackedMLP.init(n_models, model_type, input_dim, n_classes,
                              generator=torch.Generator().manual_seed(seed), device=self.device)
        self.params = [t for w, b in zip(mlp.weights, mlp.biases) for t in (w.data, b.data)]
        self.opt_state = adam_init(self.params)
        self.parts: Optional[List[_Part]] = None
        if self.devices is not None and n_models % len(self.devices) == 0:
            per = n_models // len(self.devices)
            self.parts = [_Part(i * per, (i + 1) * per, dev, self.params)
                          for i, dev in enumerate(self.devices)]
            self.params = self.opt_state = None  # the parts own them
        self.class_mask = torch.ones((n_models, n_classes), dtype=torch.bool, device=self.device)
        self.class_weight: Optional[torch.Tensor] = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._placed = None  # (grouped, its placement over the devices)

    def full_params(self) -> List[torch.Tensor]:
        """Every model's parameters on ``device`` (the parts' joined)."""
        if self.parts is None:
            return self.params
        return [torch.cat([p.params[i].to(self.device) for p in self.parts])
                for i in range(len(self.parts[0].params))]

    @property
    def mlp(self) -> StackedMLP:
        """The trained models, as the index holds them."""
        params = self.full_params()
        return StackedMLP([p.detach().clone() for p in params[0::2]],
                          [p.detach().clone() for p in params[1::2]])

    def set_class_mask(self, mask) -> None:
        """(n_models, n_classes) bool — False marks classes a node does not use."""
        self.class_mask = torch.as_tensor(np.asarray(mask, bool), device=self.device)

    def set_class_weight(self, weight) -> None:
        """(n_models, n_classes) f32 per-class loss weights; None = unweighted."""
        self.class_weight = (
            None if weight is None
            else torch.as_tensor(np.asarray(weight, np.float32), device=self.device)
        )

    def _place(self, grouped: GroupedData):
        """The parts' layouts (expert parallel) or the row blocks (data
        parallel) of ``grouped``, made once a layout."""
        from learnedmetricindex_tpu_torch.parallel.distributed import split_rows

        if self._placed is None or self._placed[0] is not grouped:
            placed = ([_part_rows(grouped, p.lo, p.hi, p.device) for p in self.parts]
                      if self.parts is not None
                      else split_rows(grouped.x, self.spread, grouped.x_scales))
            self._placed = (grouped, placed)
        return self._placed[1]

    def run(self, grouped: GroupedData, steps: int, active: np.ndarray) -> torch.Tensor:
        """``steps`` updates (epochs for the reference rule) of the active
        models; returns the last per-model losses."""
        ref = self.update_rule == "reference"
        if self.spread is None:
            self.params, self.opt_state, losses = _run_epochs(
                self.params, self.opt_state, self.generator, grouped, self.class_mask, active,
                self.class_weight, batch_size=self.batch_size, steps=steps, lr=self.lr,
                ref_dynamics=ref,
            )
            return losses
        placed = self._place(grouped)
        runt = (grouped.seg_lens.clamp_min(1) - 1) % self.batch_size + 1 if ref else None
        losses = None
        for s0 in range(0, steps, 256):
            idx_block = batch_indices(
                self.generator, grouped.seg_starts, grouped.seg_lens,
                batch_size=self.batch_size, steps=min(256, steps - s0), ref_dynamics=ref,
            )
            if self.parts is not None:
                losses = self._expert_steps(idx_block, grouped, placed, active, runt)
            else:
                losses = self._data_steps(idx_block, grouped, placed, active, runt)
        return losses

    def _expert_steps(self, idx_block, grouped, placed, active, runt):
        """Each part steps its own models on its own device."""
        cw = self.class_weight
        if runt is not None and cw is None:
            cw = torch.ones(self.class_mask.shape, device=self.device)
        ctx = []
        for part, local in zip(self.parts, placed):
            lo, hi, dev = part.lo, part.hi, part.device
            act = np.asarray(active, bool)[lo:hi]
            ctx.append((part, local, int(grouped.seg_starts[lo]), self.class_mask[lo:hi].to(dev),
                        torch.as_tensor(act, device=dev), bool(act.all()),
                        None if cw is None else cw[lo:hi].to(dev),
                        None if runt is None else runt[lo:hi].to(dev)))
        losses = []
        for idx in idx_block:
            losses = []
            for part, local, s0, mask, act, all_act, cw_p, runt_p in ctx:
                xb, yb = batch_rows(local, (idx[part.lo:part.hi] - s0).to(part.device))
                part.params, part.state, loss = train_step(
                    part.params, part.state, xb, yb, mask, act, cw_p, lr=self.lr,
                    all_active=all_act, runt=runt_p)
                losses.append(loss.to(self.device))
        return torch.cat(losses) if losses else None

    def _data_steps(self, idx_block, grouped, blocks, active, runt):
        """Each device takes the loss over the batch entries whose rows it
        holds; the gradients meet on ``devices[0]``, which takes the Adam
        step.  ``blocks`` is ``RowBlocks`` or, across ranks, ``RankRows``:
        a rank computes its own block's part and ``add_in_order`` brings
        the others' (one ``all_gather``), so both add the same parts in
        the same order."""
        home, B = self.device, self.batch_size
        D = len(blocks.starts) - 1
        cw = self.class_weight
        if runt is not None and cw is None:
            cw = torch.ones(self.class_mask.shape, device=home)
        act = torch.as_tensor(np.asarray(active, bool), device=home)
        all_act = bool(np.all(active))
        on = {dev: (self.class_mask.to(dev), act.to(dev), None if cw is None else cw.to(dev))
              for dev in {blocks.device_of(i) for i in blocks.owned()}}
        starts = torch.as_tensor(blocks.starts[1:-1], device=home)
        col = torch.arange(B, device=home)
        shapes = [p.shape for p in self.params]
        sizes = [p.numel() for p in self.params]
        losses = None
        for idx in idx_block:
            rows = grouped.slot_rows[idx]
            yb = torch.where(rows >= 0, grouped.labels[idx], -1)
            if runt is not None:
                yb = torch.where(col[None, :] < runt[:, None], yb, -1)
            denom = None
            if cw is not None:
                w = torch.where(yb >= 0, torch.gather(cw, 1, yb.clamp_min(0)), 0.0)
                denom = torch.clamp_min(w.sum(1), 1e-12)
            # each model's batch entries grouped by the device holding their
            # rows (in batch order within a device); one read of the counts
            owner = torch.bucketize(rows.clamp_min(0), starts, right=True)
            order = torch.argsort(owner * B + col, dim=1)
            cnt = torch.nn.functional.one_hot(owner, D).sum(1)  # (M, D)
            first = torch.cumsum(cnt, 1) - cnt
            widths = cnt.max(0).values.tolist()
            replicas, parts = {}, {}
            for i in blocks.owned():
                if widths[i] == 0:
                    continue
                dev = blocks.device_of(i)
                block, scales = blocks.local(i)
                j = torch.arange(widths[i], device=home)
                sel = torch.gather(order, 1, (first[:, i : i + 1] + j).clamp_max(B - 1))
                mine = j[None, :] < cnt[:, i : i + 1]
                local = (torch.gather(rows, 1, sel) - int(blocks.starts[i])).clamp(
                    0, block.shape[0] - 1).to(dev)
                y_i = torch.where(mine, torch.gather(yb, 1, sel), -1).to(dev)
                xb = block[local].float()
                if scales is not None:
                    xb = xb * scales[local][:, :, None]
                mask, act_d, cw_d = on[dev]
                if dev not in replicas:
                    replicas[dev] = [p.to(dev) for p in self.params]
                leaves = [p.detach().requires_grad_(True) for p in replicas[dev]]
                ce = _cross_entropy(leaves, xb, y_i, mask)
                if cw_d is None:
                    part = torch.where(y_i >= 0, ce, 0.0).sum(1) / B
                else:
                    w_i = torch.where(y_i >= 0, torch.gather(cw_d, 1, y_i.clamp_min(0)), 0.0)
                    part = (w_i * ce).sum(1) / denom.to(dev)
                grads = torch.autograd.grad((part * act_d).sum(), leaves)
                # gradients and losses, flat, added in device (rank) order
                parts[i] = torch.cat([t.reshape(-1).to(home) for t in grads]
                                     + [part.detach().to(home)])
            pieces = torch.split(blocks.add_in_order(parts, sum(sizes) + len(act)),
                                 sizes + [len(act)])
            grads, losses = [t.reshape(s) for t, s in zip(pieces, shapes)], pieces[-1]
            self.params, self.opt_state = adam_update(
                self.params, self.opt_state, grads, act, lr=self.lr, all_active=all_act)
        return losses

    def _predict(self, grouped: GroupedData) -> torch.Tensor:
        """Per-slot predictions over the whole layout, on ``device``."""
        if self.world is not None:
            return self._rank_predict(grouped)
        if self.parts is None:
            return _predict_own_tiles(self.params, grouped, self.class_mask)
        placed = self._place(grouped)
        return torch.cat([
            _predict_own_tiles(p.params, local, self.class_mask[p.lo:p.hi].to(p.device))
            .to(self.device) for p, local in zip(self.parts, placed)])

    def _rank_predict(self, grouped: GroupedData) -> torch.Tensor:
        """Across ranks: this rank predicts every slot from the rows it
        holds (the others read its first row and are dropped), and each
        slot takes its row's owner's prediction from the ranks' joined by
        ``to_host_replicated``: the tiles' shapes are the one-device
        call's, so the predictions are its bits."""
        from learnedmetricindex_tpu_torch.parallel import multiprocess as mp

        rr = grouped.x
        srt = grouped.slot_rows
        owner = rr.owner(srt.clamp_min(0))
        local = grouped._replace(
            x=rr.block, x_scales=rr.scales,
            slot_rows=torch.where((srt >= 0) & (owner == self.world.rank), srt - rr.lo, -1))
        every = mp.to_host_replicated(_predict_own_tiles(self.params, local, self.class_mask)[None],
                                      self.world)
        owner = owner.cpu().numpy()
        return torch.as_tensor(every[owner, np.arange(len(owner))], device=self.device)

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
            preds = self._predict(grouped)
            covered = _coverage(preds, grouped.labels, grouped.tile_model, self.class_mask)
            covered = covered.cpu().numpy()
            rounds += 1
            if covered.all():
                break
            if rounds > max_rounds:
                raise RuntimeError(f"The model did not converge after {max_rounds} iterations.")
            active = ~covered
        self._placed = None  # the parts' copies of the rows go with the fit
        return preds.cpu().numpy().astype(np.int32), rounds

    def predict_slots(self, grouped: GroupedData) -> np.ndarray:
        """Per-slot argmax under each slot's own model."""
        out = self._predict(grouped).cpu().numpy().astype(np.int32)
        self._placed = None
        return out

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

    @property
    def params(self) -> List[dict]:
        """The model's layers as the JAX package lists them: ``[{"w": (in,
        out), "b": (out,)}, ...]``, tensors on the trainer's device."""
        p = self._trainer.params
        return [{"w": w[0], "b": b[0]} for w, b in zip(p[0::2], p[1::2])]

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
