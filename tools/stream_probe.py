#!/usr/bin/env python3
"""Time the streaming kernels on the card, each beside what it must beat,
in turns in one process, optionally against other builds of the kernel
library.

    python3 tools/stream_probe.py [--only=pred,csr,fires,counts,sdsa,apec,gate]
                                  [NAME=CSRC_DIR ...]

Kernel 10 (the predicated spike matmul, csrc/spike_matmul.cu) at
SegNet-64's tconv shapes, (131072x288)x(288x16) and (524288x144)x(144x2),
on a map with every tile occupied (as the model's maps nearly are) and on
clustered data with 50% occupied tiles: kernel 10 and cuBLAS fp32 in
turns, kernel 12 on `build_csr` of the same map (its result must equal
kernel 10's bit for bit), the byte bound and the bytes a second kernel 10
reaches. Kernels 12 and 14 (the pipelined CSR matmul on f32 spikes and
on words, csrc/spike_matmul_csr_pipe.cu) at SpikingFormer-4-384's stage
1, fc1 and fc2 (T=4, B=32) on clustered data with 50% occupied tiles:
each with cuBLAS fp32 in turns, the launch its C library reports, and
kernels 12, 13 and 14 equal bit for bit; and the serial kernels 11 and
13 (csrc/spike_matmul_csr.cu, event walks) at the same shapes, at the
packed stage-1 width (K = 576), and on
SpikingFormer-4-384's fc1, fc2 and stage-1 spikes (one forward, as
chip_smoke's phase (i) captures it): kernel 11 or 13 with cuBLAS fp32 in
turns, the pipelined kernel of the same form beside, the live events and
density, the event and dense-tile bounds, each equal bit for bit to the
k-order chain (`spike_matmul.spike_matmul_csr_chain_plain`). The plain
LIF fire
(csrc/lif.cu `lif_kernel`) at SpikingFormer's stage-1 drive (4,
32*1024*96) f32, plain and residual, and the LM's hidden drives (2,
8*5632) and (2, 8*1024*5632) bf16: back-to-back calls (`ms`), the kernel
alone in a CUDA graph (`device_ms`), the byte bound and a device copy of
the same bytes (`Tensor.copy_`). The counts fires (csrc/lif.cu
`lif_counts_kernel`: rows 4, 6 and 5) at chip_smoke's FIRE_DRIVES, each
with its launch, `device_ms`, the byte bound, a device copy moving as
many bytes and a sum of the drive (`read_ms`, its bytes read once). The
SDSA kernels (csrc/sdsa.cu, csrc/sdsa_causal.cu: rows 7-8 and 9) at
chip_smoke's shapes, their word entries and their spike entries on the
models' head views, each with `device_ms`, the plain version, a device
copy of the same bytes and (row 9) `torch.cummax`; an older build's
spike ops run the word route around its word kernels (pack, pad, kernel,
unpack), as its registry did. The serial APEC kernels (csrc/
apec_matmul_csr.cu: rows 17 and 15) at g = 2 on SpikingFormer-4-384's
fc1, fc2 and stage-1 spikes (one forward, as chip_smoke's phase (i)
captures it) and on clustered data with 50% occupied tiles: kernel 17
with cuBLAS fp32 in turns, kernel 15 on the same spikes' words, each
equal bit for bit to the k-order chain
(`spike_matmul.apec_matmul_csr_chain_plain`), with the pipelined kernel
(18 or 16) beside, the events, the event and dense-tile bounds; and
before them row 19 (csrc/apec.cu) at g = 2 on the same fc1, fc2 and
stage-1 spikes: the word entry on their words and the spike entry on the
spikes, each with `device_ms`, the byte bound and a device copy of the
same bytes, equal to its plain version (a build from before the spike
entry runs the old dense route around its word kernel: pad, pack,
kernel, unpack). The gated kernels of hybrid dispatch (`gate`: rows 10,
11 and 17 on the same fc1, fc2 and stage-1 spikes): each build's ungated
entry and this build's gated entry with the gate on and off, device ms
from CUDA graphs in turns, the gate's cost and each other build's time,
the outputs equal bit for bit. `--only` runs the named probes alone.

Each CSRC_DIR is another tree's `src/repro_torch/csrc` (an older commit
unpacked with `git archive`, or a patched copy), built here with this
checkout's flags; its kernels 11 to 14, fires, counts fires, SDSA
entries, serial APEC kernels and row 19's entries are timed in turns
with this checkout's
(this, other, other, this) and must give the same bits. A patched copy
may hold only the sources it changes (each probe takes the builds that
export its C entries); a build that fails to compile is printed, left
out, and makes the run fail.
Prints the card's name and power limit, the ptxas registers and spills
of each fresh build's kernel-11 to 14, fire, SDSA and serial APEC instances,
then one JSON line per case; exits nonzero on a mismatch."""
import ctypes
import functools
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on the path)

TCONV_SHAPES = (("tconv1", (131072, 288, 16)), ("tconv2", (524288, 144, 2)))
# Phase (j)'s packed stage-1 patch matrix: 9 x 64 columns, the 48
# channels zero-padded to whole 32-bit words.
PACKED_STAGE1 = ("econv_stage1_k576", (cs.T * cs.B * 1024, 576, 96))

# The serial APEC kernels 17 and 15 (the same signatures in every build).
APEC_ENTRIES = ("apec_matmul_csr_forward", "apec_matmul_packed_csr_forward")
# Row 19: the word entry (one signature in every build) and the spike
# entry (absent from older builds).
DECOMPOSE_ENTRIES = ("apec_decompose_forward",
                     "apec_decompose_spikes_forward")
# The serial CSR kernels 11 and 13 (likewise).
WALK_ENTRIES = ("spike_matmul_csr_forward",
                "spike_matmul_packed_csr_forward")
# The kernels hybrid dispatch gates (rows 10, 11 and 17): entry -> its
# gated twin (absent from builds before the gate).
GATED_ENTRIES = {"spike_matmul_pred_forward":
                 "spike_matmul_pred_routed_forward",
                 "spike_matmul_csr_forward": "spike_matmul_csr_routed_forward",
                 "apec_matmul_csr_forward": "apec_matmul_csr_routed_forward"}
ENTRIES = WALK_ENTRIES + tuple(GATED_ENTRIES) + \
    tuple(GATED_ENTRIES.values()) + ("spike_matmul_csr_pipe_forward",
           "spike_matmul_packed_csr_pipe_forward", "lif_forward",
           "lif_bf16_forward", "lif_fwd_forward", "lif_counts_forward",
           "lif_counts_packed_forward", "lif_counts_fwd_forward") + \
    APEC_ENTRIES + DECOMPOSE_ENTRIES
PTXAS_KERNELS = ("csr_pipe_kernel", "lif_kernel", "lif_counts_kernel",
                 "sdsa_or_kernel", "sdsa_causal_kernel", "apec_walk_kernel",
                 "apec_csr_kernel", "csr_walk_kernel", "csr_matmul_kernel",
                 "apec_kernel")
# The counts fires (rows 4, 6 and 5): C entry -> wrapper name.
COUNTS_ENTRIES = (("lif_counts_forward", "lif_counts"),
                  ("lif_counts_packed_forward", "lif_counts_packed"),
                  ("lif_counts_fwd_forward", "lif_counts_fwd"))
PROBES = ("pred", "csr", "fires", "counts", "sdsa", "apec", "gate")
# The SDSA kernels' word entries before they read spikes (an older build):
# C entry -> argument types.
OLD_SDSA_SIGNATURES = {
    "sdsa_or_forward": (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 3 +
    (ctypes.c_void_p,),
    "sdsa_causal_forward": (ctypes.c_void_p,) * 2 + (ctypes.c_int64,) * 3 +
    (ctypes.c_void_p,)}
NEW_SDSA_ENTRIES = ("sdsa_or_strided_forward", "sdsa_causal_strided_forward",
                    "sdsa_capture_id")
LIF_KW = dict(decay=0.5, v_th=1.0, soft_reset=1)


def ptxas_summary(log: str) -> list:
    """[(entry, registers, spill stores, spill loads)] of the kernels in
    PTXAS_KERNELS, read from an `nvcc -Xptxas -v` log."""
    rows, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        if entry is None or not any(k in entry for k in PTXAS_KERNELS):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((entry, int(m.group(1)), *spills))
            entry = None
    return rows


def load_other(csrc: Path):
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(_build.build(csrc=csrc)))
    sdsa = NEW_SDSA_ENTRIES if hasattr(lib, NEW_SDSA_ENTRIES[0]) else \
        tuple(OLD_SDSA_SIGNATURES)
    for name in ENTRIES + sdsa:
        if not hasattr(lib, name):          # a build of only some sources
            continue
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES.get(name) or
                           OLD_SDSA_SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib, _build.BUILD_INFO.get("log", "")


def having(others, *entries):
    """The other builds that export every C entry in `entries` (a patched
    copy may hold only the sources it changes)."""
    return {name: lib for name, lib in others.items()
            if all(hasattr(lib, e) for e in entries)}


def csr_call(lib, entry, a, w, csr, k, out):
    """One launch of the CSR kernel at C entry `entry` of `lib` (kernels
    11-14: one signature for f32 spikes, one for words, which add their
    word count) into `out`."""
    from repro_torch.kernels import _build
    m, n = a.shape[0], w.shape[1]
    dims = (m, a.shape[1], k, n) if "packed" in entry else (m, k, n)
    _build.check(getattr(lib, entry)(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), csr.row_ptr.data_ptr(),
        csr.tile_k_idx.data_ptr(), csr.occ.data_ptr(), *dims, -(-m // 128),
        _build.stream()), entry)
    return out


def fire_call(lib, entry, x, s, vres=None):
    from repro_torch.kernels import _build
    t, p = x.shape
    args = [x.data_ptr(), s.data_ptr()]
    if vres is not None:
        args.append(vres.data_ptr())
    _build.check(getattr(lib, entry)(*args, t, p, LIF_KW["decay"],
                                     LIF_KW["v_th"], LIF_KW["soft_reset"],
                                     _build.stream()), entry)
    return (s,) if vres is None else (s, vres)


def counts_outputs(torch, name, x):
    """The buffers a counts fire writes for the (T, R, K) drive x."""
    t, r, k = x.shape
    out = {"counts": torch.zeros((-(-t * r // 8), -(-k // 128)),
                                 dtype=torch.int32, device=x.device)}
    if name == "lif_counts_packed":
        out["words"] = torch.empty((t, r, -(-k // 32)), dtype=torch.int32,
                                   device=x.device)
    else:
        out["s"] = torch.empty_like(x)
    if name == "lif_counts_fwd":
        out["vres"] = torch.empty_like(x)
    return out


def counts_call(lib, entry, x, out):
    """One launch of a counts fire into `out`; a ragged R zeroes the map
    first, as the wrapper does (the kernel adds into it)."""
    from repro_torch.kernels import _build
    t, r, k = x.shape
    if r % 8:
        out["counts"].zero_()
    ptrs = [x.data_ptr()]
    ptrs += [out["words" if "words" in out else "s"].data_ptr(),
             out["counts"].data_ptr()]
    if "vres" in out:
        ptrs.append(out["vres"].data_ptr())
    _build.check(getattr(lib, entry)(*ptrs, t, r, k, LIF_KW["decay"],
                                     LIF_KW["v_th"], LIF_KW["soft_reset"],
                                     _build.stream()), entry)
    return tuple(out.values())


def probe_counts(torch, device, this, others):
    """Rows 4, 6 and 5 at chip_smoke's FIRE_DRIVES: this build's kernel
    (`ms`, `device_ms` in a CUDA graph), each other build's in turns, a
    device copy of as many bytes (`copy_ms`) and the byte bound; every
    build's outputs must be the same bits."""
    from repro_torch.kernels import lif_scan
    dgen = torch.Generator(device=device).manual_seed(cs.SEED)
    ok = True
    for label, shape in cs.FIRE_DRIVES:
        x = cs.fire_drive(torch, label, shape, dgen, device)
        for entry, name in COUNTS_ENTRIES:
            outs = {b: counts_outputs(torch, name, x)
                    for b in ("this", *others)}
            run = {b: functools.partial(counts_call, lib, entry, x, outs[b])
                   for b, lib in (("this", this), *others.items())}
            n_bytes = x.numel() * 4 + sum(
                t.numel() * t.element_size() for t in outs["this"].values())
            half = torch.empty(n_bytes // 8, device=device)
            dst = torch.empty_like(half)
            rec = {"kernel": entry, "case": label, "shape": list(shape),
                   "ms": cs.cuda_ms(torch, run["this"]),
                   "device_ms": cs.graph_ms(torch, run["this"]),
                   "copy_ms": cs.cuda_ms(torch, functools.partial(
                       dst.copy_, half)),
                   "read_ms": cs.cuda_ms(torch, x.sum),
                   "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                   "launch": lif_scan.counts_launch(shape[1], shape[2],
                                                    name)}
            for b in others:
                a, o = cs.turns_ms(torch, run["this"], run[b])
                same = all(torch.equal(p, q) for p, q in zip(
                    run["this"](), run[b]()))
                rec[b] = {"ms": o, "this_ms": a, "equal": same}
                ok &= same
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            print(json.dumps(rec), flush=True)
    return ok


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


def probe_csr(torch, gen, device, this, others):
    from repro_torch.core.spikes import build_csr, pack_spikes_padded
    from repro_torch.kernels import ops, spike_matmul as sm
    ok = True
    for label, (m, k, n) in cs.CSR_SHAPES:
        s = cs.clustered_spikes(torch, m, k, gen, device)
        w = (torch.randn((k, n), generator=gen) / k ** 0.5).to(device)
        occ = ops.padded_occupancy(s)
        csr = build_csr(occ, 128, 128)
        p = pack_spikes_padded(s).contiguous()
        k13 = sm.spike_matmul_packed_csr(p, w, csr)
        flops, _ = cs.csr_work(torch, occ, m, k, n)
        nnz = cs.live_nonzeros(torch, s, occ)
        libs = (("this", this), *others.items())
        for kernel, a, launch, spike_bytes in (
                ("spike_matmul_csr_pipe", s, sm.pipe_launch, 4.0),
                ("spike_matmul_packed_csr_pipe", p, sm.packed_pipe_launch,
                 1 / 8)):
            outs = {name: torch.empty((m, n), device=device)
                    for name, _ in libs}
            run = {name: functools.partial(csr_call, lib, kernel + "_forward",
                                           a, w, csr, k, outs[name])
                   for name, lib in libs}
            ms, cublas_ms = cs.turns_ms(torch, run["this"], functools.partial(
                torch.matmul, s, w))
            same = torch.equal(run["this"](), k13)
            _, n_bytes = cs.csr_work(torch, occ, m, k, n,
                                     spike_bytes=spike_bytes)
            rec = {"kernel": kernel, "case": label, "ms": ms,
                   "cublas_ms": cublas_ms, "launch": launch(n, -(-m // 128)),
                   **cs.spike_bounds(n_bytes, nnz, n, flops),
                   "equal_to_kernel_13": same,
                   "occupied_share": (occ > 0).float().mean().item()}
            ok &= same
            for name in others:
                t, o = cs.turns_ms(torch, run["this"], run[name])
                same = torch.equal(outs["this"], outs[name])
                rec[name] = {"ms": o, "this_ms": t, "equal": same}
                ok &= same
            print(json.dumps(rec), flush=True)
    return ok


def probe_csr_walk(torch, gen, device, this, others):
    """Kernels 11 (f32) and 13 (words) at CSR_SHAPES and PACKED_STAGE1 on
    clustered data with 50% occupied tiles and on SpikingFormer-4-384's
    fc1, fc2 and stage-1 spikes (one forward, as chip_smoke's phase (i)
    captures it): `ms` with
    cuBLAS fp32 on the spikes in turns, each other build in turns (this,
    other, other, this), the pipelined kernel of the same form (12 or 14),
    the live events, the event and dense-tile bounds
    (`chip_smoke.spike_bounds`); every build's output equal to the k-order
    chain bit for bit."""
    from repro_torch.core.spikes import build_csr, pack_spikes_padded
    from repro_torch.kernels import dispatch, ops, spike_matmul as sm
    cap = cs.apec_capture(torch, device)
    (s1, w1, _), (s2, w2, _) = cap["spike_matmul"][:2]
    s_conv, w_conv, _ = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    model = {"ffn_fc1": (s1.reshape(-1, s1.shape[-1]), w1),
             "ffn_fc2": (s2.reshape(-1, s2.shape[-1]), w2),
             "econv_stage1": (dispatch.econv_patches(s_conv, kh, kw, 1,
                                                     "SAME"),
                              w_conv.permute(2, 0, 1, 3).reshape(
                                  ci * kh * kw, co))}
    cases = []
    for label, (m, k, n) in cs.CSR_SHAPES + (PACKED_STAGE1,):
        w = (torch.randn((k, n), generator=gen) / k ** 0.5).to(device)
        cases.append((label, "clustered50",
                      cs.clustered_spikes(torch, m, k, gen, device), w))
    for label, (s, w) in model.items():
        cases.append((label, "model", s.float().contiguous(),
                      w.float().contiguous()))
    libs = (("this", this), *others.items())
    ok = True
    for label, data, s, w in cases:
        m, k = s.shape
        n = w.shape[1]
        occ = ops.padded_occupancy(s)
        csr = build_csr(occ, 128, 128)
        p = pack_spikes_padded(s).contiguous()
        chain = sm.spike_matmul_csr_chain_plain(s, w, csr)
        flops, _ = cs.csr_work(torch, occ, m, k, n)
        nnz = cs.live_nonzeros(torch, s, occ)
        for entry, a, pipe, spike_bytes in (
                (WALK_ENTRIES[0], s, sm.spike_matmul_csr_pipe, 4.0),
                (WALK_ENTRIES[1], p, sm.spike_matmul_packed_csr_pipe,
                 1 / 8)):
            outs = {name: torch.empty((m, n), device=device)
                    for name, _ in libs}
            run = {name: functools.partial(csr_call, lib, entry, a, w, csr,
                                           k, outs[name])
                   for name, lib in libs}
            ms, cublas_ms = cs.turns_ms(torch, run["this"], functools.partial(
                torch.matmul, s, w))
            _, n_bytes = cs.csr_work(torch, occ, m, k, n,
                                     spike_bytes=spike_bytes)
            rec = {"kernel": entry[:-len("_forward")],
                   "case": f"{label}_{data}", "ms": ms,
                   "cublas_ms": cublas_ms,
                   "pipe_ms": cs.cuda_ms(torch, functools.partial(
                       pipe, a, w, csr)),
                   **cs.spike_bounds(n_bytes, nnz, n, flops),
                   "events": nnz, "density": nnz / max(
                       1, (occ > 0).sum().item() * 128 * 128),
                   "occupied_share": (occ > 0).float().mean().item(),
                   "shape": [m, k, n]}
            for name in others:
                t, o = cs.turns_ms(torch, run["this"], run[name])
                rec[name] = {"ms": o, "this_ms": t}
            for name, _ in libs:
                same = torch.equal(run[name](), chain)
                ok &= same
                if name == "this":
                    rec["equal_to_chain"] = same
                else:
                    rec[name]["equal_to_chain"] = same
            rec["bound_share"] = rec["bound_ms"] / ms
            print(json.dumps(rec), flush=True)
    return ok


def probe_fires(torch, device, this, others):
    dgen = torch.Generator(device=device).manual_seed(cs.SEED)
    cases = (("lif_forward", "stage1_f32", (cs.T, cs.B * 1024 * 96),
              torch.float32, False),
             ("lif_fwd_forward", "stage1_f32", (cs.T, cs.B * 1024 * 96),
              torch.float32, True),
             ("lif_bf16_forward", "decode_hidden", (2, cs.LM_BATCH * 5632),
              torch.bfloat16, False),
             ("lif_bf16_forward", "prefill_hidden",
              (2, cs.LM_BATCH * cs.LM_PROMPT * 5632), torch.bfloat16, False))
    ok = True
    for entry, label, shape, dt, residual in cases:
        x = (torch.randn(shape, generator=dgen, device=device) * 0.8
             + 0.6).to(dt)
        outs = {name: (torch.empty_like(x), torch.empty(
            shape, device=device) if residual else None)
            for name in ("this", *others)}
        run = {name: functools.partial(fire_call, lib, entry, x,
                                       *outs[name])
               for name, lib in (("this", this), *others.items())}
        n_bytes = x.numel() * x.element_size() * 2 + (
            x.numel() * 4 if residual else 0)
        rec = {"kernel": entry, "case": label, "shape": list(shape),
               "ms": cs.cuda_ms(torch, run["this"]),
               "device_ms": cs.graph_ms(torch, run["this"]),
               "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3}
        if not residual:      # the same bytes, read once and written once
            dst = torch.empty_like(x)
            rec["copy_ms"] = cs.cuda_ms(torch, functools.partial(
                dst.copy_, x))
        for name in others:
            a, b = cs.turns_ms(torch, run["this"], run[name])
            same = all(torch.equal(p, q) for p, q in zip(
                run["this"](), run[name]()))
            rec[name] = {"ms": b, "this_ms": a, "equal": same}
            ok &= same
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        print(json.dumps(rec), flush=True)
    return ok


def sdsa_entries(torch, lib):
    """(word OR, word causal status, spike OR, spike causal) callables of
    one build: this tree's entries on `lib`; for a build from before the
    spike entries, its word kernels and, for the spike ops, the word route
    around them (pack, pad, kernel, unpack: `ops.sdsa_or_words`,
    `ops.causal_sdsa_words`), as that tree's registry ran them."""
    from repro_torch.kernels import _build, ops, sdsa_kernel as sk
    if lib is _build.library():       # this tree: its wrappers as called
        return (sk.sdsa_packed, sk.sdsa_causal_status, sk.sdsa_or_spikes,
                sk.causal_sdsa_spikes)
    if hasattr(lib, NEW_SDSA_ENTRIES[0]):
        def w_or(q, k, v):
            return sk._launch(False, q, k, v, torch.empty_like(q), lib=lib)

        def w_causal(kv):
            return sk._launch(True, kv, kv, kv, torch.empty_like(kv),
                              words=True, lib=lib)

        def s_causal(q, k, v):
            return sk._launch(True, q, k, v, torch.empty_like(q), lib=lib)
        return w_or, w_causal, w_or, s_causal

    def w_or(q, k, v):
        out = torch.empty_like(q)
        _build.check(lib.sdsa_or_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.shape, _build.stream()), "sdsa_or")
        return out

    def w_causal(kv):
        out = torch.empty_like(kv)
        _build.check(lib.sdsa_causal_forward(
            kv.data_ptr(), out.data_ptr(), *kv.shape, _build.stream()),
            "sdsa_causal")
        return out
    return (w_or, w_causal,
            lambda q, k, v: ops.sdsa_or_words(q, k, v, w_or),
            lambda q, k, v: ops.causal_sdsa_words(q, k, v, w_causal))


def probe_sdsa(torch, device, this, others):
    """The SDSA kernels at chip_smoke's shapes: the word entries (row 7-8
    at (1024, 64, 2); row 9 at (256, 1024, 2), (32, 32768, 2), (256, 1000,
    2)) and the spike entries on the models' head views (SpikingFormer's
    (4, 32, 8, 64, 48) f32; one LM prefill layer's (2, 8, 32, 1024, 64)
    bf16 and its 32k row (2, 1, 32, 32768, 64)): `ms` (back-to-back
    calls), `device_ms` (a CUDA graph), the plain version, the byte bound,
    a device copy of the same bytes (`copy_ms`), for row 9
    `torch.cummax`; each other build in turns (this, other, other, this),
    the same bits."""
    from repro_torch.core.spikes import pack_spikes, unpack_spikes
    from repro_torch.kernels import sdsa_kernel as sk
    dgen = torch.Generator(device=device).manual_seed(cs.SEED)
    libs = {"this": this, **others}
    entries = {name: sdsa_entries(torch, lib) for name, lib in libs.items()}

    def words(shape, p):
        bits = torch.rand(shape[:-1] + (32 * shape[-1],), generator=dgen,
                          device=device) < p
        return pack_spikes(bits).contiguous()

    def heads(shape, p, dtype):
        return cs.head_spikes(torch, dgen, shape, p, dtype, device)

    cases = [("word_or", "spikingformer", 0,
              [words((1024, 64, 2), 0.3) for _ in range(3)],
              sk.sdsa_packed_plain, None)]
    for label, shape in (("prefill_b8_n1024", (256, 1024, 2)),
                         ("prefill_32k_b1", (32, 32768, 2)),
                         ("ragged_n1000", (256, 1000, 2))):
        kv = words(shape, 1 / (4 * shape[1]))
        dense = unpack_spikes(kv, dtype=torch.bfloat16)
        cases.append(("word_causal", label, 1, [kv],
                      sk.sdsa_causal_status_plain,
                      functools.partial(torch.cummax, dense, dim=1)))
    cases.append(("spike_or", "spikingformer", 2,
                  [heads((cs.T, cs.B, 64, cs.HEADS, cs.DIM // cs.HEADS),
                         0.3, torch.float32) for _ in range(3)],
                  sk.sdsa_or_spikes_plain, None))
    for label, shape in (("lm_prefill", (2, cs.LM_BATCH, cs.LM_PROMPT, 32,
                                         64)),
                         ("lm_32k_b1", (2, 1, 32768, 32, 64))):
        p = (1 / (8 * shape[2])) ** 0.5
        q, k, v = heads(shape, 0.2, torch.bfloat16), \
            heads(shape, p, torch.bfloat16), heads(shape, p, torch.bfloat16)
        kv = ((k != 0) & (v != 0)).any(0).to(torch.bfloat16)
        cases.append(("spike_causal", label, 3, [q, k, v],
                      sk.causal_sdsa_spikes_plain,
                      functools.partial(torch.cummax, kv, dim=-2)))
    ok = True
    for kind, label, slot, args, plain, library in cases:
        run = {name: functools.partial(e[slot], *args)
               for name, e in entries.items()}
        got = run["this"]()
        same = torch.equal(got.view(torch.int32) if got.dtype ==
                           torch.uint32 else got,
                           plain(*args).view(torch.int32) if got.dtype ==
                           torch.uint32 else plain(*args))
        ok &= same
        n_bytes = sum(a.numel() * a.element_size() for a in args) + \
            got.numel() * got.element_size()
        half = torch.empty(n_bytes // 8, device=device)
        dst = torch.empty_like(half)
        rec = {"kernel": kind, "case": label, "shape": list(args[0].shape),
               "equal_to_plain": same, "ms": cs.cuda_ms(torch, run["this"]),
               "device_ms": cs.graph_ms(torch, run["this"]),
               "plain_ms": cs.cuda_ms(torch, functools.partial(plain, *args),
                                      reps=5),
               "copy_ms": cs.cuda_ms(torch, functools.partial(dst.copy_,
                                                              half)),
               "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3}
        if library is not None:
            rec["cummax_ms"] = cs.cuda_ms(torch, library)
        for name in others:
            a, b = cs.turns_ms(torch, run["this"], run[name])
            mine, theirs = run["this"](), run[name]()
            eq = torch.equal(mine.view(torch.int32), theirs.view(
                torch.int32)) if mine.dtype == torch.uint32 else \
                torch.equal(mine, theirs)
            rec[name] = {"ms": b, "this_ms": a, "equal": eq,
                         "device_ms": cs.graph_ms(torch, run[name])}
            ok &= eq
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        print(json.dumps(rec), flush=True)
    return ok


def apec_call(lib, entry, res, ov, w, g, work, k, out):
    """One launch of a serial APEC kernel (`entry`, one of APEC_ENTRIES)
    of `lib` into `out`."""
    from repro_torch.kernels import _build
    csr, occ_r, occ_o = work
    m, n = res.shape[0], w.shape[1]
    dims = (m, res.shape[1], k, n) if entry == APEC_ENTRIES[1] else (m, k, n)
    _build.check(getattr(lib, entry)(
        res.data_ptr(), ov.data_ptr(), w.data_ptr(), out.data_ptr(),
        csr.row_ptr.data_ptr(), csr.tile_k_idx.data_ptr(), occ_r.data_ptr(),
        occ_o.data_ptr(), *dims, -(-m // 128), g, _build.stream()), entry)
    return out


def probe_apec(torch, gen, cap, this, others):
    """Kernels 17 (f32) and 15 (words) at g = 2 on the model's fc1, fc2
    and stage-1 spikes and on clustered data: `ms` with cuBLAS fp32 on
    the spikes in turns, each other build in turns (this, other, other,
    this), the pipelined kernel of the same form (18 or 16), the events,
    the bounds (`chip_smoke.apec_bounds`); every build's output equal to
    the k-order chain bit for bit."""
    from repro_torch.core.spikes import (pack_spikes_padded,
                                         ragged_tile_occupancy)
    from repro_torch.kernels import dispatch, ops, spike_matmul as sm
    g = 2
    device = cap["econv"][0][1].device
    (s1, w1, _), (s2, w2, _) = cap["spike_matmul"][:2]
    s_conv, w_conv, _ = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    cases = (("ffn_fc1", s1.reshape(-1, s1.shape[-1]), w1),
             ("ffn_fc2", s2.reshape(-1, s2.shape[-1]), w2),
             ("econv_stage1",
              dispatch.econv_patches(s_conv, kh, kw, 1, "SAME"),
              w_conv.permute(2, 0, 1, 3).reshape(ci * kh * kw, co)))
    libs = (("this", this), *others.items())
    ok = True
    for label, s_model, w in cases:
        m, k = s_model.shape
        n = w.shape[1]
        w = w.float().contiguous()
        syn = cs.clustered_spikes(torch, m, k, gen, device)
        for data, s in (("model", s_model.float().contiguous()),
                        ("clustered50", syn)):
            ov, res = ops.apec_decompose(s, g)
            res, ov = res.contiguous(), ov.contiguous()
            work = ops.apec_union_worklist(res, ov, g)
            map_r = ops.padded_occupancy(res)
            map_o = ragged_tile_occupancy(ov, 128 // g, 128)
            flops, _ = cs.csr_work(torch, map_r, m, k, n, map_o, g)
            events = cs.apec_events(torch, s, res, ov, map_r, map_o, g)
            chain = sm.apec_matmul_csr_chain_plain(res, ov, w, g, *work)
            words = (pack_spikes_padded(res).contiguous(),
                     pack_spikes_padded(ov).contiguous())
            for entry, operands, pipe, spike_bytes in (
                    (APEC_ENTRIES[0], (res, ov), sm.apec_matmul_csr_pipe,
                     4.0),
                    (APEC_ENTRIES[1], words, sm.apec_matmul_packed_csr_pipe,
                     1 / 8)):
                outs = {name: torch.empty((m, n), device=device)
                        for name, _ in libs}
                run = {name: functools.partial(apec_call, lib, entry,
                                               *operands, w, g, work, k,
                                               outs[name])
                       for name, lib in libs}
                ms, cublas_ms = cs.turns_ms(torch, run["this"],
                                            functools.partial(torch.matmul,
                                                              s, w))
                _, n_bytes = cs.csr_work(torch, map_r, m, k, n, map_o, g,
                                         spike_bytes=spike_bytes)
                rec = {"kernel": entry[:-len("_forward")],
                       "case": f"{label}_{data}", "ms": ms,
                       "cublas_ms": cublas_ms,
                       "pipe_ms": cs.cuda_ms(torch, functools.partial(
                           pipe, *operands, w, g, *work)),
                       **cs.apec_bounds(False, n_bytes, flops,
                                        events["events"], n),
                       **events, "shape": [m, k, n]}
                for name in others:
                    t, o = cs.turns_ms(torch, run["this"], run[name])
                    rec[name] = {"ms": o, "this_ms": t}
                for name, _ in libs:
                    same = torch.equal(run[name](), chain)
                    ok &= same
                    if name == "this":
                        rec["equal_to_chain"] = same
                    else:
                        rec[name]["equal_to_chain"] = same
                rec["bound_share"] = rec["bound_ms"] / ms
                print(json.dumps(rec), flush=True)
    return ok


def decompose_entries(torch, lib):
    """(word entry, spike entry) of row 19 in one build, each (x, g) ->
    (overlap, residual): this tree's wrappers as the routes call them; for
    another build its C entries, and where it has no spike entry (an
    older build) the old dense route around its word kernel
    (`chip_smoke.old_decompose_route`), as that tree's
    `ops.apec_decompose` ran it."""
    from repro_torch.kernels import _build, apec_kernel
    if lib is _build.library():
        return (apec_kernel.apec_decompose_packed,
                apec_kernel.apec_decompose_spikes)

    def words(x, g):
        p, dw = x.shape
        ov = torch.empty((p // g, dw), dtype=x.dtype, device=x.device)
        res = torch.empty_like(x)
        _build.check(lib.apec_decompose_forward(
            x.data_ptr(), ov.data_ptr(), res.data_ptr(), p, dw, g,
            _build.stream()), "apec_decompose")
        return ov, res

    def spikes(s, g):
        p, c = s.shape
        ov = torch.empty((p // g, c), dtype=s.dtype, device=s.device)
        res = torch.empty((p, c), dtype=s.dtype, device=s.device)
        _build.check(lib.apec_decompose_spikes_forward(
            s.data_ptr(), ov.data_ptr(), res.data_ptr(), p, c, s.stride(0),
            g, apec_kernel.KIND[s.dtype], _build.stream()),
            "apec_decompose_spikes")
        return ov, res

    return words, (spikes if hasattr(lib, DECOMPOSE_ENTRIES[1]) else
                   functools.partial(cs.old_decompose_route, torch,
                                     words=words))


def probe_decompose(torch, cap, this, others):
    """Row 19's word and spike entries at g = 2 on SpikingFormer-4-384's
    fc1, fc2 and stage-1 spikes (and their words): `ms` (back-to-back
    calls), `device_ms` (a CUDA graph), the byte bound, a device copy of
    the same bytes; each other build in turns (this, other, other, this),
    its word kernel and its spike entry or old route, with their
    `device_ms`; every build's outputs equal to the plain version bit for
    bit."""
    from repro_torch.core.spikes import pack_spikes_padded
    from repro_torch.kernels import apec_kernel, dispatch
    g = 2
    (s1, _, _), (s2, _, _) = cap["spike_matmul"][:2]
    s_conv, w_conv, _ = cap["econv"][0]
    dense = {"ffn_fc1": s1.reshape(-1, s1.shape[-1]),
             "ffn_fc2": s2.reshape(-1, s2.shape[-1]),
             "econv_stage1": dispatch.econv_patches(
                 s_conv, w_conv.shape[0], w_conv.shape[1], 1, "SAME")}
    entries = {name: decompose_entries(torch, lib)
               for name, lib in (("this", this), *others.items())}
    plains = (apec_kernel.apec_decompose_packed_plain,
              apec_kernel.apec_decompose_spikes_plain)
    ok = True
    for label, s in dense.items():
        for slot, x in enumerate((pack_spikes_padded(s).contiguous(), s)):
            want = plains[slot](x, g)
            run = {name: functools.partial(e[slot], x, g)
                   for name, e in entries.items()}
            n_bytes = x.element_size() * (2 * x.numel() + x.numel() // g)
            rec = {"kernel": ("apec_decompose", "apec_decompose_spikes")[slot],
                   "case": label, "g": g, "shape": list(x.shape),
                   "ms": cs.cuda_ms(torch, run["this"]),
                   "device_ms": cs.graph_ms(torch, run["this"]),
                   "copy_ms": cs.copy_ms(torch, n_bytes, x.device),
                   "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3}
            for name, fn in run.items():
                same = all(cs.same_words(torch, a, b)
                           for a, b in zip(fn(), want))
                ok &= same
                if name == "this":
                    rec["equal_to_plain"] = same
                    continue
                a, b = cs.turns_ms(torch, run["this"], fn)
                rec[name] = {"ms": b, "this_ms": a,
                             "device_ms": cs.graph_ms(torch, fn),
                             "equal_to_plain": same}
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            print(json.dumps(rec), flush=True)
    return ok


def gated_call(lib, entry, args, route):
    """One launch of a gated kernel's C entry `entry` of `lib` (rows 10,
    11, 17: `args` its pointer and size arguments), through its gated twin
    with the device int `route` when one is given."""
    from repro_torch.kernels import _build
    if route is None:
        _build.check(getattr(lib, entry)(*args, _build.stream()), entry)
    else:
        twin = GATED_ENTRIES[entry]
        _build.check(getattr(lib, twin)(*args, route.data_ptr(),
                                        _build.stream()), twin)


def probe_gate(torch, cap, this, others):
    """Rows 10, 11 and 17 (kernel 10, the predicated matmul; kernel 11,
    the CSR walk; kernel 17, the APEC walk at g = 2) on SpikingFormer-4-384's
    fc1, fc2 and stage-1 spikes with their exact maps: each build's
    ungated entry (`null`) and this build's gated entry with the gate on
    and off, as device ms from a CUDA graph of 20 launches, in turns
    (null, on, other builds, then back). `gate_cost` is on / null - 1;
    each other build's `vs` is this build's null / its time - 1. Every
    output equal bit for bit to this build's null launch; gated off
    leaves a sentinel untouched."""
    from repro_torch.core.spikes import build_csr
    from repro_torch.kernels import dispatch, ops
    (s1, w1, _), (s2, w2, _) = cap["spike_matmul"][:2]
    s_conv, w_conv, _ = cap["econv"][0]
    kh, kw, ci, co = w_conv.shape
    model = {"ffn_fc1": (s1.reshape(-1, s1.shape[-1]), w1),
             "ffn_fc2": (s2.reshape(-1, s2.shape[-1]), w2),
             "econv_stage1": (dispatch.econv_patches(s_conv, kh, kw, 1,
                                                     "SAME"),
                              w_conv.permute(2, 0, 1, 3).reshape(
                                  ci * kh * kw, co))}
    dev = s1.device
    flags = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    ok = True
    for label, (s, w) in model.items():
        s, w = s.float().contiguous(), w.float().contiguous()
        m, k = s.shape
        n = w.shape[1]
        occ = ops.padded_occupancy(s).contiguous()
        csr = build_csr(occ, 128, 128)
        ov, res = ops.apec_decompose(s, 2)
        ov, res = ov.float().contiguous(), res.float().contiguous()
        csr_a, occ_r, occ_o = ops.apec_union_worklist(res, ov, 2, occ)
        for entry in GATED_ENTRIES:
            out = {}

            def args(o, entry=entry):
                if entry == "spike_matmul_pred_forward":
                    return (s.data_ptr(), w.data_ptr(), o.data_ptr(),
                            occ.data_ptr(), m, k, n, occ.shape[1])
                if entry == "spike_matmul_csr_forward":
                    return (s.data_ptr(), w.data_ptr(), o.data_ptr(),
                            csr.row_ptr.data_ptr(),
                            csr.tile_k_idx.data_ptr(), csr.occ.data_ptr(),
                            m, k, n, -(-m // 128))
                return (res.data_ptr(), ov.data_ptr(), w.data_ptr(),
                        o.data_ptr(), csr_a.row_ptr.data_ptr(),
                        csr_a.tile_k_idx.data_ptr(), occ_r.data_ptr(),
                        occ_o.data_ptr(), m, k, n, -(-m // 128), 2)
            variants = {"null": (this, None), "on": (this, flags[0:1]),
                        "off": (this, flags[1:2]),
                        **{name: (lib, None) for name, lib in
                           having(others, entry).items()}}
            run = {}
            for name, (lib, route) in variants.items():
                out[name] = torch.full((m, n), 12345.0, device=dev)
                run[name] = functools.partial(gated_call, lib, entry,
                                              args(out[name]), route)
                run[name]()
            torch.cuda.synchronize()
            order = [name for name in variants if name != "off"]
            first = {name: cs.graph_ms(torch, run[name]) for name in order}
            second = {name: cs.graph_ms(torch, run[name])
                      for name in reversed(order)}
            ms = {name: (first[name] + second[name]) / 2 for name in order}
            same = {name: torch.equal(out[name], out["null"])
                    for name in order}
            off_untouched = bool((out["off"] == 12345.0).all())
            ok &= all(same.values()) and off_untouched
            rec = {"kernel": entry[:-len("_forward")], "case": f"{label}_model",
                   "shape": [m, k, n], "null_ms": ms["null"],
                   "on_ms": ms["on"], "off_ms": cs.graph_ms(torch, run["off"]),
                   "gate_cost": ms["on"] / ms["null"] - 1,
                   "equal": same, "off_untouched": off_untouched,
                   "occupied_share": (occ > 0).float().mean().item()}
            for name in order[2:]:
                rec[name] = {"ms": ms[name], "vs": ms["null"] / ms[name] - 1}
            print(json.dumps(rec), flush=True)
    return ok


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    device = torch.device("cuda", 0)
    cs.phase_device(torch)
    this = _build.library()
    logs = {"this": _build.BUILD_INFO.get("log", "")}
    others, only, failed = {}, PROBES, False
    for arg in argv:
        if arg.startswith("--only="):
            only = tuple(arg[len("--only="):].split(","))
            continue
        name, _, path = arg.partition("=")
        try:
            others[name], logs[name] = load_other(Path(path).resolve())
        except RuntimeError as err:          # reported, left out, and fails
            print(json.dumps({"build": name, "error": str(err)[-4000:]}),
                  flush=True)
            failed = True
    for name, log in logs.items():
        for entry, regs, st, ld in ptxas_summary(log):
            print(json.dumps({"build": name, "entry": entry,
                              "registers": regs, "spill_stores": st,
                              "spill_loads": ld}), flush=True)
    gen = torch.Generator().manual_seed(cs.SEED)
    ok = True
    if "pred" in only:
        ok &= probe_pred(torch, gen, device)
    if "csr" in only:
        ok &= probe_csr(torch, gen, device, this, having(
            others, "spike_matmul_csr_pipe_forward",
            "spike_matmul_packed_csr_pipe_forward"))
        ok &= probe_csr_walk(torch, gen, device, this,
                             having(others, *WALK_ENTRIES))
    if "fires" in only:
        ok &= probe_fires(torch, device, this, having(
            others, "lif_forward", "lif_fwd_forward", "lif_bf16_forward"))
    if "counts" in only:
        ok &= probe_counts(torch, device, this, having(
            others, *(entry for entry, _ in COUNTS_ENTRIES)))
    if "sdsa" in only:
        ok &= probe_sdsa(torch, device, this, {
            name: lib for name, lib in others.items()
            if hasattr(lib, "sdsa_or_forward") or
            hasattr(lib, NEW_SDSA_ENTRIES[0])})
    if "apec" in only:
        cap = cs.apec_capture(torch, device)
        ok &= probe_decompose(torch, cap, this,
                              having(others, DECOMPOSE_ENTRIES[0]))
        ok &= probe_apec(torch, gen, cap, this,
                         having(others, *APEC_ENTRIES))
    if "gate" in only:
        ok &= probe_gate(torch, cs.apec_capture(torch, device), this, others)
    return 0 if ok and not failed else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
