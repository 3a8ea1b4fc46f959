"""Optimizer state of the row-sparse train steps (counterpart of
``esrecsys_tpu/ops/optim.py``): both momentum carriers, LazyAdam, and
dense Adam and RMSprop in optax's order (the last with optax's
staircase exponential decay).

The dense carrier keeps one momentum buffer per table and decays all of it
every step. The lazy carrier touches only the rows a step gathered: a row
idle for k steps would have moved ``p -= lr * m * (mu + mu^2 + ... +
mu^k)`` and decayed ``m *= mu^k`` under dense SGD momentum, and both
closed forms are applied at the row's next touch (the "catch-up").
:func:`momentum_flush` applies every row's outstanding catch-up, so lazy
plus flush is the dense trajectory up to float32 rounding. LazyAdam
(:func:`lazy_adam_update`) updates the moments and rows of the touched
rows only, with the bias correction of the global step (TF's LazyAdam;
not dense Adam, which moves idle rows while their moments decay).

Tables and moments are float32 or bf16 (``momentum_init`` and
``adam_init`` take the state's dtype; bf16 halves the bytes of a 100M-row
table). The per-row arithmetic is float32, in the reference's order, and
each result is rounded to the state's dtype where the reference casts it:
the scatters add float32 updates rounded to the table's dtype, as the
reference's ``at[].add(updates.astype(table.dtype))`` does. LazyAdam
multiplies bf16 moments by ``b1`` and ``b2`` in bf16, as the reference's
``b1 * m_rows`` does for a bf16 ``m_rows``.

Tables and state update in place; the step number is a Python int. Rows
of the tables and moments go through :func:`gather_rows` (the row-gather
kernel on the card, which widens bf16 rows exactly; the reference uses a
plain ``jnp.take`` here), the segment sum and the scatters through
:func:`scatter_add_rows` (the scatter-add kernel). The duplicate handling
keeps the reference's static shapes: a stable sort, a ``first`` mask and a
segment sum into an (n, D) buffer, never ``torch.unique``, whose output
size would need the device to report back to the host every step. Only
the first occurrence of a row updates it; the others scatter zeros.

The reference's 128-lane packed layouts (``lazy_adam_packed_update``,
``pack_rows`` and the rest) are a TPU layout trick and are not ported.

On a mesh (``rows_sharded``, a ``core.mesh.Mesh``) a table is this rank's
row-shard and its state the state of those rows. The reference's
``rows_sharded`` only turns its packed layout off, GSPMD doing the rest
(its ``_like_table_sharding`` places the state with the table's rows);
here it means, for the row-sparse updates: every data rank's ids and row
gradients are gathered over the data axis (so each replica applies the
sum of all data rows' updates, in one order on every replica), global ids
become ids local to the shard, and rows another shard owns are dropped
(id -1, which the row kernels read as a zero row and whose updates they
drop); for the dense updates (:func:`adam_update`, :func:`rmsprop_update`):
the gradient, this data row's part of the shard's (or of a replicated
parameter's) gradient, is summed over the data axis in place before the
update.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch.core.mesh import Mesh
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows

State = Dict[str, torch.Tensor]


def momentum_init(table: torch.Tensor, lazy: bool = False,
                  dtype: torch.dtype = torch.float32) -> State:
    """A zero momentum buffer of ``dtype`` shaped like the table (float32,
    or bf16 where device memory is the constraint); the lazy carrier adds
    ``last_step``, the int32 step (R,) at which each row was last
    settled."""
    state = {"momentum": torch.zeros(table.shape, dtype=dtype,
                                     device=table.device)}
    if lazy:
        state["last_step"] = torch.zeros((table.shape[0],), dtype=torch.int32,
                                         device=table.device)
    return state


def _decay(last: torch.Tensor, mu: float, step: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu^k, mu * (1 - mu^k) / (1 - mu)) in float32 for rows last settled
    at ``last``, with k = max(step - last, 0) idle steps."""
    k = (step - last).clamp_(min=0).to(torch.float32)
    mu_k = torch.full_like(k, mu).pow_(k)
    geom = mu * (1.0 - mu_k) / max(1.0 - mu, 1e-12)
    return mu_k, geom


def _row_steps(state: State, ids: torch.Tensor) -> torch.Tensor:
    last = state["last_step"]
    return last.index_select(0, ids.long().clamp(0, last.shape[0] - 1))


def momentum_catchup_rows(state: State, ids: torch.Tensor, *, lr: float,
                          mu: float, step: int) -> torch.Tensor:
    """(n, D) float32 settlement deltas of the rows ``ids`` at ``step``.
    The forward pass must see the settled rows (raw rows plus these), or
    its gradients are taken at stale parameters. Duplicate ids get equal
    deltas."""
    m_rows = gather_rows(state["momentum"], ids)
    _, geom = _decay(_row_steps(state, ids), mu, step)
    return -lr * m_rows * geom[:, None]


def _first_occurrences(ids: torch.Tensor, row_grads: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """(sorted ids, first-occurrence mask, per-slot gradients, 0/1 weights
    (n, 1)): duplicate ids' gradients summed into the first occurrence of
    the stably sorted ids, zeros at the others."""
    n = ids.shape[0]
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    sgrads = row_grads.index_select(0, order)
    first = torch.ones((n,), dtype=torch.bool, device=ids.device)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    agg = scatter_add_rows(torch.zeros_like(sgrads), seg, sgrads)
    g = torch.where(first[:, None], agg.index_select(0, seg), 0.0)
    return sids, first, g, first.to(torch.float32)[:, None]


def shard_updates(table: torch.Tensor, ids: torch.Tensor,
                  row_grads: torch.Tensor, rows_sharded: Optional[Mesh]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, row gradients) to apply to ``table``: unchanged without a
    mesh; on one, every data rank's gathered and the ids made local to
    this rank's shard of ``table`` (-1 where another shard owns the
    row)."""
    if rows_sharded is None:
        return ids, row_grads
    ids = rows_sharded.gather_data(ids)
    row_grads = rows_sharded.gather_data(row_grads)
    return rows_sharded.owned(ids, table.shape[0]), row_grads


def sgd_update(table: torch.Tensor, ids: torch.Tensor,
               row_grads: torch.Tensor, *, lr: float,
               rows_sharded: Optional[Mesh] = None) -> None:
    """Row-sparse SGD without momentum: ``table[ids] -= lr * row_grads``,
    duplicates summed, in place."""
    ids, row_grads = shard_updates(table, ids, row_grads, rows_sharded)
    scatter_add_rows(table, ids, -lr * row_grads)


def dense_momentum_update(table: torch.Tensor, state: State,
                          ids: torch.Tensor, row_grads: torch.Tensor, *,
                          lr: float, mu: float,
                          rows_sharded: Optional[Mesh] = None) -> None:
    """The dense momentum carrier's step, in place: ``m *= mu``, the row
    gradients scatter-added into ``m`` (duplicates sum, as the dense
    gradient would), ``p -= lr * m``; optax's SGD-momentum trace."""
    ids, row_grads = shard_updates(table, ids, row_grads, rows_sharded)
    m = state["momentum"]
    m.mul_(mu)
    scatter_add_rows(m, ids, row_grads)
    table.sub_(lr * m)


def lazy_momentum_update(table: torch.Tensor, state: State,
                         ids: torch.Tensor, row_grads: torch.Tensor, *,
                         lr: float, mu: float, step: int,
                         rows_sharded: Optional[Mesh] = None) -> None:
    """One exact sparse SGD-momentum step on the rows ``ids`` (n,), with
    ``row_grads`` (n, D) the gradients at the settled rows; updates
    ``table`` and ``state`` in place. Duplicate ids sum their gradients
    into the first occurrence of the sorted ids, so each row's catch-up
    and momentum update apply once; the other occurrences add zeros (so
    do ids of -1, rows another shard owns)."""
    ids, row_grads = shard_updates(table, ids, row_grads, rows_sharded)
    if ids.shape[0] == 0:
        return
    sids, first, g, w = _first_occurrences(ids, row_grads)

    m_rows = gather_rows(state["momentum"], sids)
    mu_k, geom = _decay(_row_steps(state, sids), mu, step)
    catchup = -lr * m_rows * geom[:, None]
    m_caught = m_rows * mu_k[:, None]
    m_new = mu * m_caught + g
    delta = (catchup - lr * m_new) * w

    scatter_add_rows(table, sids, delta)
    scatter_add_rows(state["momentum"], sids, (m_new - m_rows) * w)
    # drop out-of-range ids, as the scatters do: max with 0 changes nothing
    rows = state["last_step"].shape[0]
    keep = first & (sids >= 0) & (sids < rows)
    state["last_step"].scatter_reduce_(
        0, sids.long().clamp_(0, rows - 1),
        torch.where(keep, step + 1, 0).to(torch.int32), reduce="amax")


def _settlement(state: State, lr: float, mu: float,
                step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(every row's outstanding table delta, mu^k per row)."""
    mu_k, geom = _decay(state["last_step"], mu, step)
    delta = torch.mul(state["momentum"].float(), -lr).mul_(geom[:, None])
    return delta, mu_k


def momentum_flush(table: torch.Tensor, state: State, *, lr: float,
                   mu: float, step: int) -> torch.Tensor:
    """A new table, in the table's dtype, with every row's outstanding
    catch-up applied in float32: the dense SGD-momentum trajectory at
    ``step``. ``table`` and ``state`` are not touched (training continues
    from them)."""
    delta, _ = _settlement(state, lr, mu, step)
    return delta.add_(table).to(table.dtype)


def momentum_settle(table: torch.Tensor, state: State, *, lr: float,
                    mu: float, step: int) -> None:
    """Settle every row in place: apply its catch-up to ``table``, decay
    its momentum by ``mu^k`` and set ``last_step`` to ``step``. A
    synchronization barrier, needed at a learning-rate boundary: the
    catch-up's closed form assumes one lr since the row's last touch, so a
    piecewise-constant schedule settles with the old lr before switching,
    and the lazy trajectory stays the dense one of the stepwise
    schedule."""
    delta, mu_k = _settlement(state, lr, mu, step)
    table.add_(delta)
    del delta
    state["momentum"].mul_(mu_k[:, None])
    state["last_step"].fill_(step)


def adam_init(table: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> State:
    """LazyAdam's zero moments ``m`` and ``v`` of ``dtype`` shaped like the
    table."""
    return {k: torch.zeros(table.shape, dtype=dtype, device=table.device)
            for k in ("m", "v")}


def _decayed(rows: torch.Tensor, decay: float,
             dtype: torch.dtype) -> torch.Tensor:
    """``decay * rows`` as the reference computes it for moments of
    ``dtype``: in float32, or in bf16 (the Python scalar takes the array's
    dtype, and the product is rounded to it) for bf16 moments; float32
    out."""
    if dtype == torch.float32:
        return rows * decay
    return (rows.to(dtype) * torch.tensor(decay, dtype=dtype,
                                          device=rows.device)).float()


def lazy_adam_update(table: torch.Tensor, state: State, ids: torch.Tensor,
                     row_grads: torch.Tensor, *, lr: float, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8,
                     step: int, rows_sharded: Optional[Mesh] = None) -> None:
    """TF-LazyAdam on the rows ``ids`` (n,) with ``row_grads`` (n, D): the
    moments and rows of the touched rows update, with the bias correction
    of the global ``step`` (0-based); ``table`` and ``state`` in place.
    Duplicate ids are summed into their first occurrence, as in
    :func:`lazy_momentum_update` (on a mesh, across the data rows too)."""
    ids, row_grads = shard_updates(table, ids, row_grads, rows_sharded)
    if ids.shape[0] == 0:
        return
    sids, _, g, w = _first_occurrences(ids, row_grads)
    dtype = state["m"].dtype
    m_rows = gather_rows(state["m"], sids)
    v_rows = gather_rows(state["v"], sids)
    m_new = _decayed(m_rows, b1, dtype) + (1.0 - b1) * g
    v_new = _decayed(v_rows, b2, dtype) + (1.0 - b2) * g.square()
    t = np.float32(step + 1)
    m_hat = m_new / float(np.float32(1.0) - np.float32(b1) ** t)
    v_hat = v_new / float(np.float32(1.0) - np.float32(b2) ** t)
    delta = -lr * m_hat / (v_hat.sqrt() + eps) * w
    scatter_add_rows(table, sids, delta)
    scatter_add_rows(state["m"], sids, (m_new - m_rows) * w)
    scatter_add_rows(state["v"], sids, (v_new - v_rows) * w)


def adam_update(param: torch.Tensor, grad: torch.Tensor, state: State, *,
                lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, step: int,
                rows_sharded: Optional[Mesh] = None) -> None:
    """One dense Adam step of ``param`` in place, in optax's order
    (``optax.adam(lr)`` with ``eps_root`` 0): ``mu = (1 - b1) g + b1 mu``,
    ``nu = (1 - b2) g^2 + b2 nu``, ``p += -lr * mu_hat / (sqrt(nu_hat) +
    eps)`` with the bias corrections of ``step + 1`` updates. ``state``
    holds ``mu`` and ``nu`` shaped like ``param``, float32. On a mesh
    (``rows_sharded``) ``grad`` is summed over the data axis first, in
    place."""
    if rows_sharded is not None:
        grad = rows_sharded.sum_data(grad)
    t = np.float32(step + 1)
    mu, nu = state["mu"], state["nu"]
    mu.mul_(b1).add_(grad * (1.0 - b1))
    nu.mul_(b2).add_(grad.square().mul_(1.0 - b2))
    mu_hat = mu / float(np.float32(1.0) - np.float32(b1) ** t)
    nu_hat = nu / float(np.float32(1.0) - np.float32(b2) ** t)
    param.add_(mu_hat.div_(nu_hat.sqrt_().add_(eps)).mul_(-lr))


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, count: int) -> float:
    """``optax.exponential_decay(init_value, transition_steps, decay_rate,
    staircase=True)`` at ``count``, in float32 as optax computes it:
    ``init_value * decay_rate ** floor(count / transition_steps)``, and
    ``init_value`` itself at count 0 (a ``decay_rate`` of 1 or a
    non-positive ``transition_steps`` is a constant)."""
    if transition_steps <= 0 or decay_rate == 0 or count <= 0:
        return float(np.float32(init_value))
    p = np.floor(np.float32(count) / np.float32(transition_steps))
    return float(np.float32(init_value)
                 * np.power(np.float32(decay_rate), p, dtype=np.float32))


def rmsprop_update(param: torch.Tensor, grad: torch.Tensor, state: State,
                   *, lr: float, decay: float = 0.9,
                   eps: float = 1e-8,
                   rows_sharded: Optional[Mesh] = None) -> None:
    """One dense ``optax.rmsprop(lr)`` step of ``param`` in place:
    ``nu = (1 - decay) g^2 + decay nu`` (``state["nu"]``, zeros at the
    start), then ``param += -lr * (rsqrt(nu + eps) * g)``, eps inside the
    root. ``lr`` is the schedule's value at the step's count, read before
    the count moves (:func:`exponential_decay`). Not
    ``torch.optim.RMSprop``, which takes ``alpha`` 0.99 and divides by
    ``sqrt(v) + eps``. On a mesh (``rows_sharded``) ``grad`` is summed
    over the data axis first, in place."""
    if rows_sharded is not None:
        grad = rows_sharded.sum_data(grad)
    nu = state["nu"]
    nu.mul_(decay).add_(grad.square().mul_(1.0 - decay))
    param.add_(torch.rsqrt(nu + eps).mul_(grad).mul_(-lr))
