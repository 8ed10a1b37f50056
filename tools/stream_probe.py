#!/usr/bin/env python3
"""Time the predicated spike matmul (kernel 10, csrc/spike_matmul.cu) and
the pipelined word kernel (kernel 14, csrc/spike_matmul_csr_pipe.cu) on
the card, each beside what it must beat, in turns in one process.

    python3 tools/stream_probe.py       # from the root of a checkout

Kernel 10 at SegNet-64's tconv shapes, (131072x288)x(288x16) and
(524288x144)x(144x2), on a map with every tile occupied (as the model's
maps nearly are) and on clustered data with 50% occupied tiles: kernel 10
and cuBLAS fp32 in turns, kernel 12 on `build_csr` of the same map (its
result must equal kernel 10's bit for bit), the byte bound and the bytes
a second kernel 10 reaches. Kernel 14 at SpikingFormer-4-384's stage 1,
fc1 and fc2 on clustered data with 50% occupied tiles: kernels 12 and 14
in turns, cuBLAS fp32, the launch kernel 14 picks, and the three results
equal bit for bit. Prints the card's name and power limit, then one JSON
line per case; exits nonzero on a mismatch."""
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on the path)

TCONV_SHAPES = (("tconv1", (131072, 288, 16)), ("tconv2", (524288, 144, 2)))


def probe_pred(torch, gen, device):
    from repro_torch.core.spikes import build_csr
    from repro_torch.kernels import ops, spike_matmul as sm
    for label, (m, k, n) in TCONV_SHAPES:
        w = (torch.randn((k, n), generator=gen) / k ** 0.5).to(device)
        full = (torch.rand((m, k), generator=gen) < 0.4).float().to(device)
        for data, s in (("full", full),
                        ("clustered50",
                         cs.clustered_spikes(torch, m, k, gen, device))):
            occ = ops.padded_occupancy(s)
            csr = build_csr(occ, 128, 128)
            pred = functools.partial(sm.spike_matmul_pred, s, w, occ)
            pipe = functools.partial(sm.spike_matmul_csr_pipe, s, w, csr)
            same = torch.equal(pred(), pipe())
            ms, cublas_ms = cs.turns_ms(torch, pred, functools.partial(
                torch.matmul, s, w))
            _, n_bytes = cs.csr_work(torch, occ, m, k, n)
            n_bytes += occ.numel() * 4
            print(json.dumps({
                "kernel": "spike_matmul_pred", "case": f"{label}_{data}",
                "ms": ms, "cublas_ms": cublas_ms,
                "kernel12_ms": cs.cuda_ms(torch, pipe),
                "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                "bytes_per_s": n_bytes / (ms * 1e-3),
                "equal_to_kernel12": same,
                "occupied_share": (occ > 0).float().mean().item()}),
                flush=True)
            if not same:
                return False
    return True


def probe_words(torch, gen, device):
    from repro_torch.core.spikes import build_csr, pack_spikes_padded
    from repro_torch.kernels import ops, spike_matmul as sm
    for label, (m, k, n) in cs.CSR_SHAPES:
        s = cs.clustered_spikes(torch, m, k, gen, device)
        w = (torch.randn((k, n), generator=gen) / k ** 0.5).to(device)
        occ = ops.padded_occupancy(s)
        csr = build_csr(occ, 128, 128)
        p = pack_spikes_padded(s).contiguous()
        k12 = functools.partial(sm.spike_matmul_csr_pipe, s, w, csr)
        k14 = functools.partial(sm.spike_matmul_packed_csr_pipe, p, w, csr)
        same = torch.equal(k12(), k14()) and torch.equal(
            k14(), sm.spike_matmul_packed_csr(p, w, csr))
        ms12, ms14 = cs.turns_ms(torch, k12, k14)
        flops, n_bytes = cs.csr_work(torch, occ, m, k, n, spike_bytes=1 / 8)
        print(json.dumps({
            "kernel": "spike_matmul_packed_csr_pipe", "case": label,
            "ms": ms14, "kernel12_ms": ms12,
            "cublas_ms": cs.cuda_ms(torch, functools.partial(
                torch.matmul, s, w)),
            **cs.spike_bounds(n_bytes, cs.live_nonzeros(torch, s, occ), n,
                              flops),
            "launch": sm.packed_pipe_launch(n, -(-m // 128)),
            "equal_to_kernels_12_13": same,
            "occupied_share": (occ > 0).float().mean().item()}), flush=True)
        if not same:
            return False
    return True


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.phase_device(torch)
    cs.phase_build()
    gen = torch.Generator().manual_seed(cs.SEED)
    ok = probe_pred(torch, gen, device) and probe_words(torch, gen, device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
