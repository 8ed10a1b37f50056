"""OPT3 — event-driven average-pool + fully-connected fusion (EAFC), the
port of `repro.core.eafc`.

Average pooling divides spike counts by the window size, producing
non-binary intermediates that break event purity (Sec. II-B). ExSpike
folds the 1/pool^2 scale into the FC weights offline and drives the FC
directly from the pre-pool spike events (Algorithm 1, lines 17-24): a
pre-pool event at (h, w, c) uses the weight row of pooled position
(h//p, w//p) and channel c, scaled by 1/p^2. A plain `torch.einsum`: the
JAX package has no kernel for it either. Exact for divisible windows
(what the paper's models use).
"""
from __future__ import annotations

import torch


def avgpool2d(s: torch.Tensor, pool: int) -> torch.Tensor:
    """(N,H,W,C) -> (N,H/p,W/p,C) mean pooling (the non-event baseline)."""
    n, h, w, c = s.shape
    return s.reshape(n, h // pool, pool, w // pool, pool, c).mean(dim=(2, 4))


def avgpool_fc_ref(s: torch.Tensor, w_fc: torch.Tensor,
                   pool: int) -> torch.Tensor:
    """Oracle: avgpool -> flatten (H',W',C order) -> FC.
    w_fc: (H/p * W/p * C, n_out)."""
    pooled = avgpool2d(s, pool)
    return pooled.reshape(pooled.shape[0], -1) @ w_fc


def scale_fc_weights(w_fc: torch.Tensor, pool: int) -> torch.Tensor:
    """Offline weight scaling (Sec. III-B): each weight divided by pool^2."""
    return w_fc / float(pool * pool)


def eafc(s: torch.Tensor, w_fc: torch.Tensor, pool: int) -> torch.Tensor:
    """Event-driven fused avgpool+FC on pre-pool spikes.

    s: (N,H,W,C) binary; w_fc: (H/p * W/p * C, n_out). Pre-pool positions
    are grouped by their pooled cell; events inside a cell share the same
    (scaled) weight row, so each active event performs exactly one
    weight-row accumulation and no non-binary intermediate exists.
    """
    n, h, w, c = s.shape
    hp, wp = h // pool, w // pool
    ws = scale_fc_weights(w_fc, pool).reshape(hp, wp, c, -1)
    sg = s.reshape(n, hp, pool, wp, pool, c)
    return torch.einsum("nhawbc,hwco->no", sg, ws)


def eafc_event_ops(s: torch.Tensor, n_out: int) -> torch.Tensor:
    """EAFC accumulation count: one n_out-row accumulate per active
    event."""
    return torch.sum(s.to(torch.int64)) * n_out
