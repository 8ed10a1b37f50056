"""APEC — adjacent-position event compression (Sec. III-A2, Fig. 5).

Adjacent spatial positions exhibit correlated spike activity, so their
channel spike sequences overlap. APEC groups g adjacent positions,
extracts the shared overlap

    O_G = AND_{i=1..g} S_i                                   (Eq. 1)

computes the overlap's contribution ONCE (caching its partial sums), and
then adds each position's disjoint residual R_i = S_i AND NOT O_G. Because
convolution / FC accumulation is linear in the input events, the
reorganization is numerically exact. Savings:

    dN_event = (g-1) |O_G|                                   (Eq. 2)
    dC       = (g-1) |O_G| * C_o * k^2                       (Eq. 3)

with overhead M_ov ~ C_o * k^2 * w_acc bits of partial-sum storage
(Eq. 4). Higher-order overlap |O_G| shrinks with g, so G2 wins in
practice (paper Fig. 7).

On the card the decomposition is one kernel launch on the spikes where
they lie (`kernels/apec_kernel.py`) and the two products share one pass
over the weight tiles (`kernels/spike_matmul.py::apec_matmul_csr`); this module is
the dense form and the public entry point.
"""
from __future__ import annotations

import dataclasses

import torch


def group_adjacent(s: torch.Tensor, g: int, axis: int = -2) -> torch.Tensor:
    """Reshape (..., P, C) -> (..., P/g, g, C): groups of g adjacent
    positions. For CNN feature maps, callers flatten (H, W) row-major first
    so groups are horizontally adjacent pixels (Fig. 5); for token
    sequences, groups are adjacent tokens."""
    s = torch.movedim(s, axis, -2)
    p = s.shape[-2]
    if p % g != 0:
        raise ValueError(f"positions {p} not divisible by group {g}")
    return s.reshape(s.shape[:-2] + (p // g, g, s.shape[-1]))


def ungroup(sg: torch.Tensor) -> torch.Tensor:
    """Inverse of `group_adjacent` (axis restored to -2)."""
    return sg.reshape(sg.shape[:-3] + (sg.shape[-3] * sg.shape[-2],
                                       sg.shape[-1]))


def apec_decompose(s: torch.Tensor, g: int):
    """Overlap/residual decomposition of grouped positions.

    s: (..., P, C) binary. Returns (overlap (..., P/g, C),
    residual (..., P/g, g, C)) with s_i == overlap OR residual_i and
    overlap AND residual_i == 0 for every member i (Fig. 5 semantics).
    """
    sg = group_adjacent(s, g)                       # (..., G, g, C)
    overlap = torch.amin(sg, dim=-2)                # AND over group members
    residual = sg * (1.0 - overlap[..., None, :])   # S_i AND NOT O_G
    return overlap, residual


def apec_reconstruct(overlap: torch.Tensor,
                     residual: torch.Tensor) -> torch.Tensor:
    """Rebuild the original grouped spikes (for equivalence tests)."""
    return ungroup(torch.maximum(residual, overlap[..., None, :]))


def apec_matmul_jnp(s: torch.Tensor, w: torch.Tensor, g: int) -> torch.Tensor:
    """Event accumulation through APEC: the overlap's partial sum is
    computed once per group and reused by its g members.

    s: (..., P, C); w: (C, F). Returns (..., P, F), exactly s @ w in value.
    (The `jnp` backend of the registry, named as in `repro`; `ref` is the
    plain dense s @ w it must match.)
    """
    overlap, residual = apec_decompose(s, g)
    psum_ov = overlap @ w                            # cached partial sums
    psum_res = residual @ w                          # unique contributions
    out = psum_res + psum_ov[..., None, :]           # reuse across members
    return out.reshape(s.shape[:-1] + (w.shape[-1],))


def apec_matmul(s, w: torch.Tensor, g: int) -> torch.Tensor:
    """APEC matmul routed through the backend registry: the fused kernel
    pair on the card, the overlap-reuse form on the CPU. `s` may be an
    `core.events.EventTensor` (carried occupancy)."""
    from repro_torch.kernels import dispatch as _dispatch  # no import cycle
    return _dispatch.apec_matmul(s, w, g=g)


@dataclasses.dataclass(frozen=True)
class ApecStats:
    events_before: torch.Tensor      # sum_i |S_i|
    events_after: torch.Tensor       # |O_G| + sum_i |R_i|
    eliminated: torch.Tensor         # (g-1)|O_G|  (Eq. 2)
    overlap_mean: torch.Tensor       # mean |O_G| per group (Fig. 7 inset)
    reduction_ratio: torch.Tensor    # before/after (paper: 1.35-1.62x)
    groups_with_overlap: torch.Tensor  # groups whose overlap pass runs

    def accum_savings(self, co: int, k: int) -> torch.Tensor:
        """Eq. 3: eliminated accumulations for a k x k conv with C_o
        outputs."""
        return self.eliminated * co * k * k


def apec_stats(s: torch.Tensor, g: int) -> ApecStats:
    """Measure APEC event statistics on a spike tensor (Fig. 7 inputs)."""
    overlap, residual = apec_decompose(s, g)
    ov = torch.sum(overlap, dtype=torch.float64) \
        if overlap.dtype == torch.float64 else torch.sum(overlap.float())
    res = torch.sum(residual.float())
    before = torch.sum(s.float())
    after = ov + res
    n_groups = torch.prod(torch.tensor(overlap.shape[:-1],
                                       dtype=torch.float32))
    overlap_mean = ov / torch.clamp(n_groups, min=1.0).to(overlap.device)
    return ApecStats(
        events_before=before,
        events_after=after,
        eliminated=(g - 1) * ov,
        overlap_mean=overlap_mean,
        reduction_ratio=before / torch.clamp(after, min=1.0),
        groups_with_overlap=torch.sum(
            (torch.sum(overlap, dim=-1) > 0).float()),
    )


def apec_overhead_bits(co: int, k: int, w_acc: int = 16) -> int:
    """Eq. 4: overlap partial-sum storage, M_ov ~ C_o k^2 w_acc bits."""
    return co * k * k * w_acc


def apec_spatial(s_map: torch.Tensor, g: int):
    """APEC over an (N, H, W, C) feature map grouping horizontally adjacent
    pixels (Fig. 5). Returns (overlap (N, H, W/g, C), residual
    (N, H, W/g, g, C))."""
    n, h, w, c = s_map.shape
    if w % g != 0:
        raise ValueError(f"width {w} not divisible by APEC group {g}")
    overlap, residual = apec_decompose(s_map.reshape(n, h * w, c), g)
    return (overlap.reshape(n, h, w // g, c),
            residual.reshape(n, h, w // g, g, c))
