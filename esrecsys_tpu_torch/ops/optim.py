"""Optimizer state of the row-sparse train step (counterpart of
``esrecsys_tpu/ops/optim.py``): both momentum carriers.

The dense carrier keeps one momentum buffer per table and decays all of it
every step. The lazy carrier touches only the rows a step gathered: a row
idle for k steps would have moved ``p -= lr * m * (mu + mu^2 + ... +
mu^k)`` and decayed ``m *= mu^k`` under dense SGD momentum, and both
closed forms are applied at the row's next touch (the "catch-up").
:func:`momentum_flush` applies every row's outstanding catch-up, so lazy
plus flush is the dense trajectory up to float32 rounding. The per-row
arithmetic is float32, in the reference's order.

Tables and state update in place; the step number is a Python int. Rows
of the table and momentum go through :func:`gather_rows` (the row-gather
kernel on the card; the reference uses a plain ``jnp.take`` here), the
segment sum and both scatters through :func:`scatter_add_rows` (the
scatter-add kernel). The duplicate handling keeps the reference's static
shapes: a stable sort, a ``first`` mask and a segment sum into an (n, D)
buffer, never ``torch.unique``, whose output size would need the device
to report back to the host every step.

The reference's LazyAdam and its 128-lane packed layouts are not ported
here (LazyAdam is GloVe's, ROADMAP queue 1 item 5; the packed layouts are
a TPU layout trick).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows

State = Dict[str, torch.Tensor]


def momentum_init(table: torch.Tensor, lazy: bool = False) -> State:
    """A float32 zero momentum buffer shaped like the table; the lazy
    carrier adds ``last_step``, the int32 step (R,) at which each row was
    last settled."""
    state = {"momentum": torch.zeros(table.shape, dtype=torch.float32,
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


def lazy_momentum_update(table: torch.Tensor, state: State,
                         ids: torch.Tensor, row_grads: torch.Tensor, *,
                         lr: float, mu: float, step: int) -> None:
    """One exact sparse SGD-momentum step on the rows ``ids`` (n,), with
    ``row_grads`` (n, D) the gradients at the settled rows; updates
    ``table`` and ``state`` in place. Duplicate ids sum their gradients
    into the first occurrence of the sorted ids, so each row's catch-up
    and momentum update apply once; the other occurrences add zeros."""
    n = ids.shape[0]
    if n == 0:
        return
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    sgrads = row_grads.index_select(0, order)
    first = torch.ones((n,), dtype=torch.bool, device=ids.device)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    agg = scatter_add_rows(torch.zeros_like(sgrads), seg, sgrads)
    g = torch.where(first[:, None], agg.index_select(0, seg), 0.0)
    w = first.to(torch.float32)[:, None]

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
    delta = torch.mul(state["momentum"], -lr).mul_(geom[:, None])
    return delta, mu_k


def momentum_flush(table: torch.Tensor, state: State, *, lr: float,
                   mu: float, step: int) -> torch.Tensor:
    """A new table with every row's outstanding catch-up applied: the
    dense SGD-momentum trajectory at ``step``. ``table`` and ``state`` are
    not touched (training continues from them)."""
    delta, _ = _settlement(state, lr, mu, step)
    return delta.add_(table)


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
