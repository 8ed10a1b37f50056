"""The CUDA kernels against their plain PyTorch versions, on a card.

Torch-only (no JAX), so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test is marked `cuda` and skips where no CUDA device is present.
Spikes (f32 and bf16), counts, membrane residuals, LIF drive cotangents,
SDSA and causal-status words, APEC overlap/residual words and spikes (the
spike entry also equal to the old pack route) and the packed fire's words
must match exactly; the CSR, predicated and fused APEC
matmuls, f32 and packed, within 1e-5 * max|plain| + 1e-5 (fp32 summation
order); the pipelined CSR kernels equal the serial ones bit for bit (the
same fmaf chains), and the serial CSR and APEC kernels (event walks)
equal their k-order chain plain versions and each other bit for bit
(the CSR ones on multi-bit spikes too), with no register spill. The pipelined APEC kernels sum on the tensor cores (an
exact bf16 split of the weights): their distance from the fp64 product
is at most twice the serial kernels' on the same inputs (2^-23 where
theirs is 0), and the word kernel equals the f32 one bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.events import EventTensor
from repro_torch.core.spikes import (build_csr, pack_spikes,
                                     pack_spikes_padded,
                                     ragged_packed_tile_occupancy,
                                     unpack_spikes_padded)
from repro_torch.kernels import apec_kernel, dispatch, launch_counts, \
    lif_scan, ops, reset_launch_counts, sdsa_kernel, spike_matmul

torch.set_num_threads(1)


def _clustered(rng, m, k, tile_p=0.5, p=0.3, tile=128):
    tiles = rng.random((-(-m // tile), -(-k // tile))) < tile_p
    mask = np.kron(tiles, np.ones((tile, tile)))[:m, :k]
    return ((rng.random((m, k)) < p) * mask).astype(np.float32)


def _err64(out, exact):
    """max |out - exact| / max |exact| (0 where both are all zero)."""
    scale = exact.abs().max().item()
    err = (out.double() - exact).abs().max().item()
    return err / scale if scale else err


def _within_twice(got, serial, exact):
    """The tensor-core kernel's fp64 distance against the serial fmaf
    kernel's on the same inputs: at most twice it, or 2^-23 where it is
    0."""
    e_tc, e_ser = _err64(got, exact), _err64(serial, exact)
    return e_tc <= (2 * e_ser if e_ser > 0 else 2.0 ** -23)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_lif_kernels_match_plain(cuda_device):
    x = (torch.randn(4, 64, 200, generator=torch.Generator().manual_seed(0))
         + 0.3).to(cuda_device)
    s, cnt = lif_scan.lif_counts(x, decay=0.5, v_th=0.5)
    ps, pcnt = lif_scan.lif_counts_plain(x, decay=0.5, v_th=0.5)
    assert torch.equal(s, ps) and torch.equal(cnt, pcnt)
    for decay in (0.5, 0.3):
        flat = x.reshape(4, -1)
        assert torch.equal(lif_scan.lif(flat, decay=decay, v_th=0.5),
                           lif_scan.lif_plain(flat, decay=decay, v_th=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 12, 200), (2, 4, 130), (3, 1, 37),
                                   (2, 20, 256)])
def test_cuda_lif_counts_take_ragged_rows(cuda_device, shape):
    """R % 8 != 0: the rows past R are masked and the chunks of the
    flattened rows (which span steps) count exactly, in the counts, the
    residual and the packed modes."""
    x = (torch.randn(shape, generator=torch.Generator().manual_seed(7))
         + 0.3).to(cuda_device)
    for got, want in ((lif_scan.lif_counts(x, decay=0.5, v_th=0.5),
                       lif_scan.lif_counts_plain(x, decay=0.5, v_th=0.5)),
                      (lif_scan.lif_counts_fwd(x, decay=0.5, v_th=0.5),
                       lif_scan.lif_counts_fwd_plain(x, decay=0.5,
                                                     v_th=0.5)),
                      (lif_scan.lif_counts_packed(x, decay=0.5, v_th=0.5),
                       lif_scan.lif_counts_packed_plain(x, decay=0.5,
                                                        v_th=0.5))):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            if a.dtype == torch.uint32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)


# The counts fires' drives at T = 4, B = 32 (SpikingFormer-4-384's stage
# 1 and 0, SegNet-64's and VGG11's first convs, the FFN's fc1 fire), a
# width K % 4 != 0, R = 12, and a drive one element into its storage.
COUNTS_DRIVES = [((4, 32768, 96), 0), ((4, 32768, 48), 0),
                 ((4, 131072, 8), 0), ((4, 32768, 64), 0),
                 ((4, 2048, 1536), 0), ((4, 4096, 37), 0), ((4, 12, 96), 0),
                 ((4, 12, 8), 0), ((4, 2048, 96), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", COUNTS_DRIVES)
def test_cuda_counts_fires_at_the_model_drives(cuda_device, shape, offset):
    """Rows 4, 5 and 6 bit for bit with their plain versions, the words
    equal to row 4's spikes packed, and the launch the C library reports
    equal to `lif_scan.counts_layout`."""
    n = int(np.prod(shape))
    buf = (torch.randn(n + offset, generator=torch.Generator().manual_seed(
        shape[2])) * 0.6 + 0.2).to(cuda_device)
    x = buf[offset:].view(shape)
    kw = dict(decay=0.5, v_th=0.5)
    for name in ("lif_counts", "lif_counts_fwd", "lif_counts_packed"):
        got = getattr(lif_scan, name)(x, **kw)
        want = getattr(lif_scan, name + "_plain")(x, **kw)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            if a.dtype == torch.uint32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), name
        launch = lif_scan.counts_launch(shape[1], shape[2], name)
        layout = lif_scan.counts_layout(shape[2])
        assert {k: launch[k] for k in layout} == layout
        assert launch["grid"] <= launch["items"]
        assert launch["grid"] in (launch["items"], launch["sms"] *
                                  launch["blocks_per_sm"])
    words, _ = lif_scan.lif_counts_packed(x, **kw)
    s, _ = lif_scan.lif_counts(x, **kw)
    assert torch.equal(words.view(torch.int32),
                       pack_spikes_padded(s).view(torch.int32))


@pytest.mark.cuda
def test_cuda_sdsa_kernel_matches_plain(cuda_device):
    g = torch.Generator().manual_seed(1)
    q, k, v = (pack_spikes((torch.rand(64, 40, 96, generator=g) < 0.3)
                           .float()).to(cuda_device) for _ in range(3))
    got = sdsa_kernel.sdsa_packed(q, k, v)
    want = sdsa_kernel.sdsa_packed_plain(q, k, v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 256, 128), (300, 200, 60),
                                   (1000, 432, 96)])
def test_cuda_csr_kernel_matches_plain(cuda_device, m, k, n):
    rng = np.random.default_rng(m)
    s = torch.from_numpy(_clustered(rng, m, k)).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                         ).to(cuda_device)
    csr = build_csr(ops.padded_occupancy(s), 128, 128)
    got = spike_matmul.spike_matmul_csr(s, w, csr)
    want = spike_matmul.spike_matmul_csr_plain(s, w, csr)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol


def _pred_case(rng, m, k, n, device, multi_bit=False):
    s = _clustered(rng, m, k)
    s[128:256] = 0                                # an all-empty m-tile row
    if multi_bit:                                 # a coded input's values
        s *= rng.integers(-128, 128, size=s.shape).astype(np.float32) / 127
    w = rng.normal(size=(k, n)).astype(np.float32)
    return (torch.from_numpy(s).to(device), torch.from_numpy(w).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,multi_bit", [
    (512, 256, 128, False),          # aligned
    (300, 200, 60, False),           # ragged M, K and N
    (1000, 144, 2, False),           # N = 2 (SegNet's last tconv)
    (600, 288, 16, False),           # N = 16 (SegNet's first tconv)
    (400, 300, 40, True),            # multi-bit s
])
def test_cuda_pred_kernel_matches_plain(cuda_device, m, k, n, multi_bit):
    rng = np.random.default_rng(m + n)
    s, w = _pred_case(rng, m, k, n, cuda_device, multi_bit)
    occ = ops.padded_occupancy(s)
    assert (occ[1] == 0).all() and (occ > 0).any()
    for the_map in (occ, torch.ones_like(occ)):
        got = spike_matmul.spike_matmul_pred(s, w, the_map)
        want = spike_matmul.spike_matmul_pred_plain(s, w, the_map)
        tol = 1e-5 * want.abs().max().item() + 1e-5
        assert (got - want).abs().max().item() <= tol
        assert torch.all(got[128:256] == 0)


@pytest.mark.cuda
def test_cuda_pred_kernel_gates_on_the_map(cuda_device):
    """A tile the map calls empty contributes nothing, even if it holds
    events; a row with no occupied tile writes zeros."""
    s = torch.ones(300, 200, device=cuda_device)
    w = torch.ones(200, 2, device=cuda_device)
    occ = torch.tensor([[1, 0], [0, 0], [0, 3]], dtype=torch.int32,
                       device=cuda_device)
    out = ops.spike_matmul(s, w, occupancy=occ)
    assert torch.all(out[:128] == 128) and torch.all(out[128:256] == 0)
    assert torch.all(out[256:] == 72)
    reset_launch_counts()
    ops.spike_matmul(s, w)
    assert launch_counts()["spike_matmul_pred"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,multi_bit", [
    (1000, 144, 2, False),           # SegNet tconv2's K and N
    (600, 288, 16, False),           # SegNet tconv1's K and N
    (300, 200, 60, False),           # ragged M, K and N (the wide path)
    (300, 27, 16, True),             # multi-bit s, K = 27: 4-byte copies
    (300, 200, 3, False),            # N short of its 4-wide tile
])
def test_cuda_pred_kernel_equals_kernel_12(cuda_device, m, k, n, multi_bit):
    """Kernel 10 (each map row's live k-tiles streamed in order) equals the
    pipelined CSR kernel 12 on the same spikes and `build_csr` of the same
    map bit for bit: one fmaf chain in k order an output. The all-empty
    m-tile row writes zeros."""
    rng = np.random.default_rng(m + k + n + 1)
    s, w = _pred_case(rng, m, k, n, cuda_device, multi_bit)
    occ = ops.padded_occupancy(s)
    gated = occ.clone()
    gated[0, 0] = 0                                # gated off, events or not
    for the_map in (occ, gated):
        got = spike_matmul.spike_matmul_pred(s, w, the_map)
        csr = build_csr(the_map, 128, 128)
        assert torch.equal(got, spike_matmul.spike_matmul_csr_pipe(s, w, csr))
        assert torch.all(got[128:256] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,form,offset", [
    (64 * 128, 384, 1536, "tma", 0),   # fc1: several tiles a block
    (64 * 128, 1536, 384, "tma", 0),   # fc2: BN = 96
    (1000, 432, 96, "tma", 0),         # stage 1's K and N, ragged M
    (300, 200, 60, "tma", 0),          # ragged M, K and N
    (4000, 27, 64, "ring", 0),         # the coded conv: K = 27
    (1000, 384, 384, "ring", 1),       # s 4 bytes off: the 4-byte ring
])
def test_cuda_pred_wide_forms_equal_kernels_11_and_12(cuda_device, m, k, n,
                                                       form, offset):
    """Kernel 10's wide path, on the TMA ring where both operands are
    16-byte aligned with K and N multiples of 4 and on the cp.async ring
    elsewhere, equals kernels 11 and 12 on `build_csr` of the same map bit
    for bit, with an empty m-tile row written as zeros and a gated-off
    launch writing nothing."""
    rng = np.random.default_rng(m + k + n + offset)
    s, w = _pred_case(rng, m, k, n, cuda_device, multi_bit=k == 27)
    if offset:
        buf = torch.empty(m * k + offset, device=cuda_device)
        buf[offset:].copy_(s.reshape(-1))
        s = buf[offset:].view(m, k)
    assert spike_matmul.pred_launch(m, k, n, aligned=not offset)["form"] \
        == form
    occ = ops.padded_occupancy(s)
    csr = build_csr(occ, 128, 128)
    got = spike_matmul.spike_matmul_pred(s, w, occ)
    assert torch.equal(got, spike_matmul.spike_matmul_csr(s, w, csr))
    assert torch.equal(got, spike_matmul.spike_matmul_csr_pipe(s, w, csr))
    assert torch.all(got[128:256] == 0)
    out = torch.full_like(got, 7.0)
    off = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    spike_matmul.spike_matmul_pred(s, w, occ, route=off, out=out)
    torch.cuda.synchronize()
    assert torch.all(out == 7.0)
    spike_matmul.spike_matmul_pred(s, w, occ, route=off + 1, out=out)
    assert torch.equal(out, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (64 * 128, 256, 384),            # fc2's N on 64 m-tiles: BN = 96
    (4000, 432, 96),                 # stage 1's K and N
    (1000, 300, 70),                 # ragged M, K and N
    (300, 200, 61),                  # N % 4 != 0: scalar stores
])
def test_cuda_word_kernel_equals_kernels_12_and_13(cuda_device, m, k, n):
    """The pipelined word kernel's predicated adds against its plain
    version, and bit for bit kernel 12 (f32 spikes) and kernel 13 (the
    serial word kernel) on the same spikes and work list."""
    rng = np.random.default_rng(m + k + n)
    s = _clustered(rng, m, k)
    s[128:256] = 0                                # an all-empty m-tile row
    s = torch.from_numpy(s).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                         ).to(cuda_device)
    p = pack_spikes_padded(s)
    csr = build_csr(ragged_packed_tile_occupancy(p, 128, 128), 128, 128)
    got = spike_matmul.spike_matmul_packed_csr_pipe(p, w, csr)
    want = spike_matmul.spike_matmul_packed_csr_pipe_plain(p, w, csr)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got, spike_matmul.spike_matmul_csr_pipe(s, w, csr))
    assert torch.equal(got, spike_matmul.spike_matmul_packed_csr(p, w, csr))
    assert torch.all(got[128:256] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("label,n,mt,bn,blocks", [
    ("econv_stage1", 96, 1024, 96, 1024),
    ("ffn_fc1", 1536, 64, 128, 768),
    ("ffn_fc2", 384, 64, 96, 256),
])
def test_cuda_word_kernel_picks_whole_waves(cuda_device, label, n, mt, bn,
                                            blocks):
    """The launch the word kernel's C library reports at SpikingFormer-4-384's
    three CSR shapes (T=4, B=32) on an H100 SXM's 132 SMs, two blocks an
    SM: fc2 takes BN = 96, 256 blocks in one wave, where BN = 64 (the
    width that pads N least) leaves 1.45 waves."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if sms != 132:
        pytest.skip(f"the expected picks are an H100 SXM's; this card has "
                    f"{sms} SMs")
    got = spike_matmul.packed_pipe_launch(n, mt)
    assert (got["bn"], got["blocks"]) == (bn, blocks), label
    assert got["grid"] == [mt, -(-n // bn)]
    assert got["thread_tile"] == {128: [8, 8], 96: [4, 12]}[bn]
    assert got["waves"] == blocks / 264
    if label == "ffn_fc2":
        assert got["waves"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,multi_bit,bn", [
    (8192 + 37, 200, 1536, False, 128),  # ragged M and K, fc1's N
    (8192 - 50, 300, 384, False, 96),    # fc2's N on 64 m-tiles
    (25600 - 3, 130, 61, False, 64),     # N % 4 != 0: 4-byte copies
    (1000, 144, 2, False, 32),           # N = 2
    (300, 27, 64, True, 32),             # the coded conv: K = 27, multi-bit
    (1000, 300, 70, False, 32),          # ragged M, K and N
])
def test_cuda_kernel_12_equals_kernel_11_at_each_bn(cuda_device, m, k, n,
                                                     multi_bit, bn):
    """Kernel 12 on its thread tile against kernel 11 (the serial fmaf
    kernel) bit for bit at each n-tile width it picks, and zeros for an
    empty m-tile row. The widths are an H100 SXM's picks (132 SMs); on
    another card the equalities still hold at whatever it picks."""
    rng = np.random.default_rng(m + k + n)
    s, w = _pred_case(rng, m, k, n, cuda_device, multi_bit)
    csr = build_csr(ops.padded_occupancy(s), 128, 128)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if sms == 132:
        assert spike_matmul.pipe_launch(n, -(-m // 128))["bn"] == bn
    got = spike_matmul.spike_matmul_csr_pipe(s, w, csr)
    assert torch.equal(got, spike_matmul.spike_matmul_csr(s, w, csr))
    assert torch.all(got[128:256] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("label,n,mt,bn,blocks", [
    ("econv_stage1", 96, 1024, 96, 1024),
    ("ffn_fc1", 1536, 64, 128, 768),
    ("ffn_fc2", 384, 64, 96, 256),
])
def test_cuda_f32_kernel_picks_whole_waves(cuda_device, label, n, mt, bn,
                                           blocks):
    """Kernel 12's launch from its C library at SpikingFormer-4-384's three
    CSR shapes (T=4, B=32) on an H100 SXM's 132 SMs: the word kernel's
    picks (one template, two blocks an SM), fc2 in one wave at BN = 96."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if sms != 132:
        pytest.skip(f"the expected picks are an H100 SXM's; this card has "
                    f"{sms} SMs")
    got = spike_matmul.pipe_launch(n, mt)
    assert got == spike_matmul.packed_pipe_launch(n, mt)
    assert (got["bn"], got["blocks"]) == (bn, blocks), label
    assert got["grid"] == [mt, -(-n // bn)]
    assert got["thread_tile"] == {128: [8, 8], 96: [4, 12]}[bn]
    assert got["waves"] == blocks / 264


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("p", [5, 1003, 4096, 8 * 1000 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_streaming_fire_matches_plain(cuda_device, t, p, offset):
    """The streaming fire, f32 and bf16, and its residual mode against
    their plain versions bit for bit at T = 1..5 (T = 5 loads in two
    groups), P < 8, P % 8 != 0 (the scalar path; at T = 1 the ragged tail
    behind whole vectors) and on drives whose rows do not start 16-byte
    aligned (a view one element into its storage)."""
    g = torch.Generator().manual_seed(t * p + offset)
    buf = (torch.randn(t * p + offset, generator=g) * 0.8 + 0.5)
    buf[offset:offset + 4] = torch.tensor([1.0, 0.5, 2.0, 0.25])
    kw = dict(decay=0.5, v_th=1.0)
    for dt in (torch.float32, torch.bfloat16):
        x = buf.to(dt).to(cuda_device)[offset:].view(t, p)
        assert x.storage_offset() == offset
        for soft in (True, False):
            got = lif_scan.lif(x, soft_reset=soft, **kw)
            assert got.dtype == dt
            assert torch.equal(got, lif_scan.lif_plain(x, soft_reset=soft,
                                                       **kw))
    xf = buf.to(cuda_device)[offset:].view(t, p)
    for soft in (True, False):
        for a, b in zip(lif_scan.lif_fwd(xf, soft_reset=soft, **kw),
                        lif_scan.lif_fwd_plain(xf, soft_reset=soft, **kw)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wrappers_count_each_launch(cuda_device):
    reset_launch_counts()
    x = torch.ones(2, 8, 130, device=cuda_device)
    lif_scan.lif(x.reshape(2, -1))
    lif_scan.lif_counts(x)
    lif_scan.lif_counts_packed(x)
    lif_scan.lif(x.reshape(2, -1).bfloat16())
    sdsa_kernel.sdsa_causal_status(torch.zeros(2, 5, 2, dtype=torch.uint32,
                                               device=cuda_device))
    assert launch_counts() == {"lif": 1, "lif_counts": 1, "lif_fwd": 0,
                               "lif_counts_fwd": 0, "lif_bwd": 0,
                               "spike_matmul_csr": 0, "spike_matmul_pred": 0,
                               "sdsa_or": 0, "sdsa_status": 0,
                               "apec_decompose": 0,
                               "apec_matmul_csr": 0, "lif_counts_packed": 1,
                               "spike_matmul_packed_csr": 0,
                               "apec_matmul_packed_csr": 0, "sdsa_causal": 1,
                               "lif_bf16": 1, "spike_matmul_csr_pipe": 0,
                               "spike_matmul_packed_csr_pipe": 0,
                               "apec_matmul_csr_pipe": 0,
                               "apec_matmul_packed_csr_pipe": 0,
                               "apec_decompose_spikes": 0,
                               "lif_fwd_bf16": 0, "lif_bwd_bf16": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,multi_bit", [
    (256, 256, 128, False),          # aligned
    (300, 200, 60, False),           # ragged M, K and N
    (1000, 432, 96, False),          # stage 1's K and N (BN = 96)
    (600, 1536, 384, False),         # fc2's K and N
    (300, 27, 64, True),             # the coded conv: K = 27, multi-bit s
    (1000, 144, 2, False),           # N = 2: 4-byte weight copies
    (260, 384, 1536, False),         # fc1's N
])
def test_cuda_csr_pipe_kernels_match_plain(cuda_device, m, k, n, multi_bit):
    """The pipelined kernels, f32 and words, against their plain versions,
    and bit for bit kernel 11 on the same spikes and work list."""
    rng = np.random.default_rng(m + k + n)
    s, w = _pred_case(rng, m, k, n, cuda_device, multi_bit)
    csr = build_csr(ops.padded_occupancy(s), 128, 128)
    got = spike_matmul.spike_matmul_csr_pipe(s, w, csr)
    want = spike_matmul.spike_matmul_csr_pipe_plain(s, w, csr)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got, spike_matmul.spike_matmul_csr(s, w, csr))
    assert torch.all(got[128:256] == 0)
    if not multi_bit:
        p = pack_spikes_padded(s)
        got_p = spike_matmul.spike_matmul_packed_csr_pipe(p, w, csr)
        want_p = spike_matmul.spike_matmul_packed_csr_pipe_plain(p, w, csr)
        assert (got_p - want_p).abs().max().item() <= tol
        assert torch.equal(got_p, got)


@pytest.mark.cuda
def test_cuda_csr_kernel_writes_zeros_for_empty_rows(cuda_device):
    s = torch.ones(300, 200, device=cuda_device)
    w = torch.ones(200, 40, device=cuda_device)
    occ = torch.tensor([[1, 0], [0, 0], [0, 3]], dtype=torch.int32,
                       device=cuda_device)
    for pipeline in (False, True):
        out = ops.spike_matmul_csr(s, w, occupancy=occ, pipeline=pipeline)
        assert torch.all(out[:128] == 128) and torch.all(out[128:256] == 0)
        assert torch.all(out[256:] == 72)


def _walk_case(rng, m, k, n, device, form, gate):
    """Kernel 11's or 13's operands: clustered spikes with an all-empty
    m-tile row (multi-bit values for `form` "multibit", words for
    "packed") and a work list from the operand's own map, from the map an
    `EventTensor` carries ("carried"), or from the own map with one live
    step's count set to 0 ("dummy": its tile's spikes must add nothing)."""
    s, w = _pred_case(rng, m, k, n, device, form == "multibit")
    packed = form == "packed"
    a = pack_spikes_padded(s) if packed else s
    if gate == "carried":
        csr = EventTensor.from_spikes(s, pack=packed).csr(128, 128)
    else:
        csr = build_csr(ops.padded_occupancy(s), 128, 128)
    if gate == "dummy":
        occ = csr.occ.clone()
        occ[0] = 0
        csr = csr._replace(occ=occ)
    return a, w, csr


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 200, 70), (1000, 432, 96),
                                   (260, 576, 33), (384, 1536, 130),
                                   (512, 384, 1536), (1024, 27, 48)])
@pytest.mark.parametrize("form", ["f32", "multibit", "packed"])
@pytest.mark.parametrize("gate", ["own", "carried", "dummy"])
def test_cuda_csr_walks_equal_their_chain(cuda_device, m, k, n, form, gate):
    """Kernels 11 (f32 spikes, any value) and 13 (words) walk their events
    in k order: equal bit for bit to the k-order fmaf chain, at ragged M,
    K and N (N % 4 != 0 included), zeros on the empty m-tile row, nothing
    from a step whose count is 0."""
    rng = np.random.default_rng(m + k + n)
    a, w, csr = _walk_case(rng, m, k, n, cuda_device, form, gate)
    if form == "packed":
        got = spike_matmul.spike_matmul_packed_csr(a, w, csr)
        chain = spike_matmul.spike_matmul_packed_csr_chain_plain(a, w, csr)
        want = spike_matmul.spike_matmul_packed_csr_plain(a, w, csr)
    else:
        got = spike_matmul.spike_matmul_csr(a, w, csr)
        chain = spike_matmul.spike_matmul_csr_chain_plain(a, w, csr)
        want = spike_matmul.spike_matmul_csr_plain(a, w, csr)
    assert torch.equal(got, chain)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    assert torch.all(got[128:256] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 200, 70), (1000, 432, 96),
                                   (384, 1536, 130), (512, 384, 1536)])
@pytest.mark.parametrize("gate", ["own", "carried", "dummy"])
def test_cuda_csr_kernels_11_to_14_are_one_chain(cuda_device, m, k, n, gate):
    """The same binary spikes and work list through the serial walks (11,
    13) and the pipelined tiles (12, 14): one fmaf chain in k order, so all
    four are equal bit for bit."""
    rng = np.random.default_rng(m + n)
    s, w, csr = _walk_case(rng, m, k, n, cuda_device, "f32", gate)
    p = pack_spikes_padded(s)
    outs = (spike_matmul.spike_matmul_csr(s, w, csr),
            spike_matmul.spike_matmul_packed_csr(p, w, csr),
            spike_matmul.spike_matmul_csr_pipe(s, w, csr),
            spike_matmul.spike_matmul_packed_csr_pipe(p, w, csr))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_cuda_walk_instances_do_not_spill(cuda_device, tmp_path):
    """Every event-walk instance (kernels 11, 13, 15 and 17) compiles
    without a register spill: ptxas's report for each file's walk
    entries, built with the library's own flags."""
    import re
    import subprocess

    from repro_torch.kernels import _build
    entries = 0
    for name, kernel in (("spike_matmul_csr.cu", "csr_walk_kernel"),
                         ("apec_matmul_csr.cu", "apec_walk_kernel")):
        log = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(_build.CSRC / name),
             "-o", str(tmp_path / (name + ".o"))], capture_output=True,
            text=True, check=True)
        entry = None
        for line in (log.stdout + log.stderr).splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = found.group(1) if kernel in found.group(1) else None
            elif entry and "spill" in line:
                assert re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                 r"loads", line), (entry, line)
                entries += 1
                entry = None
    assert entries == 4 + 16      # CSR: 2 forms x 1, 2 blocks an SM; APEC: 8 g x 2


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.5, 0.3])
@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("k", [200, 128, 37])
def test_cuda_training_lif_kernels_match_plain(cuda_device, decay, soft, k):
    """Residual forwards and the surrogate backward, ragged K included."""
    gen = torch.Generator().manual_seed(k)
    x = (torch.randn(4, 64, k, generator=gen) + 0.3).to(cuda_device)
    g = torch.randn(4, 64, k, generator=gen).to(cuda_device)
    kw = dict(decay=decay, v_th=0.5, soft_reset=soft)
    for got, want in ((lif_scan.lif_fwd(x, **kw),
                       lif_scan.lif_fwd_plain(x, **kw)),
                      (lif_scan.lif_counts_fwd(x, **kw),
                       lif_scan.lif_counts_fwd_plain(x, **kw))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    _, vres = lif_scan.lif_fwd_plain(x, **kw)
    for alpha in (2.0, 3.0):
        assert torch.equal(
            lif_scan.lif_bwd(vres, g, surrogate_alpha=alpha, **kw),
            lif_scan.lif_bwd_plain(vres, g, surrogate_alpha=alpha, **kw))


@pytest.mark.cuda
def test_cuda_training_wrappers_count_each_launch(cuda_device):
    reset_launch_counts()
    x = torch.ones(2, 8, 130, device=cuda_device)
    _, vres = lif_scan.lif_fwd(x)
    lif_scan.lif_counts_fwd(x)
    lif_scan.lif_bwd(vres, x)
    assert launch_counts() == {"lif": 0, "lif_counts": 0, "lif_fwd": 1,
                               "lif_counts_fwd": 1, "lif_bwd": 1,
                               "spike_matmul_csr": 0, "spike_matmul_pred": 0,
                               "sdsa_or": 0, "sdsa_status": 0,
                               "apec_decompose": 0,
                               "apec_matmul_csr": 0, "lif_counts_packed": 0,
                               "spike_matmul_packed_csr": 0,
                               "apec_matmul_packed_csr": 0, "sdsa_causal": 0,
                               "lif_bf16": 0, "spike_matmul_csr_pipe": 0,
                               "spike_matmul_packed_csr_pipe": 0,
                               "apec_matmul_csr_pipe": 0,
                               "apec_matmul_packed_csr_pipe": 0,
                               "apec_decompose_spikes": 0,
                               "lif_fwd_bf16": 0, "lif_bwd_bf16": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 3, 5])
@pytest.mark.parametrize("p", [5, 1003, 4096, 8 * 1000 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_bf16_training_fires_match_plain(cuda_device, t, p, offset):
    """Rows 2 and 3 on bf16 (the LM's training fires): spikes bf16, vres
    f32, dx bf16 from an f32 u, bit for bit with their plain versions at
    T = 1..5, P < 8, P % 8 != 0 (the scalar path) and rows that do not
    start 16-byte aligned; soft and hard reset, two surrogate alphas."""
    gen = torch.Generator().manual_seed(t * p + offset)
    buf = torch.randn(t * p + offset, generator=gen) * 1.3
    buf[offset:offset + 4] = torch.tensor([1.0, 0.5, 2.0, 0.25])
    x = buf.bfloat16().to(cuda_device)[offset:].view(t, p)
    g = (torch.randn(t * p + offset, generator=gen).bfloat16()
         .to(cuda_device)[offset:].view(t, p))
    for soft in (True, False):
        kw = dict(decay=0.5, v_th=1.0, soft_reset=soft)
        s, vres = lif_scan.lif_fwd(x, **kw)
        ps, pvres = lif_scan.lif_fwd_plain(x, **kw)
        assert (s.dtype, vres.dtype) == (torch.bfloat16, torch.float32)
        assert torch.equal(s, ps) and torch.equal(vres, pvres)
        assert torch.equal(s, lif_scan.lif(x, **kw))
        vres_off = torch.empty(t * p + offset, device=cuda_device)[offset:] \
            .view(t, p).copy_(vres)
        for alpha in (2.0, 4.0):
            dx = lif_scan.lif_bwd(vres_off, g, surrogate_alpha=alpha, **kw)
            assert dx.dtype == torch.bfloat16
            assert torch.equal(dx, lif_scan.lif_bwd_plain(
                vres, g, surrogate_alpha=alpha, **kw))


@pytest.mark.cuda
def test_cuda_bf16_training_wrappers_count_apart(cuda_device):
    x = torch.ones(2, 8, 130, device=cuda_device).bfloat16()
    reset_launch_counts()
    _, vres = lif_scan.lif_fwd(x)
    lif_scan.lif_bwd(vres, x)
    counts = launch_counts()
    assert (counts["lif_fwd_bf16"], counts["lif_bwd_bf16"]) == (1, 1)
    assert sum(counts.values()) == 2
    with pytest.raises(ValueError, match="f32 vres"):
        lif_scan.lif_bwd(vres.bfloat16(), x)
    with pytest.raises(ValueError, match="expected"):
        lif_scan.lif_fwd(x.half())


@pytest.mark.cuda
@pytest.mark.parametrize("sg", [lif_scan.LIFScanSG, lif_scan.LIFScanOccSG])
def test_cuda_fire_takes_the_residual_kernel_only_under_grad(cuda_device,
                                                             sg):
    primal, residual = (("lif", "lif_fwd") if sg is lif_scan.LIFScanSG
                        else ("lif_counts", "lif_counts_fwd"))
    x = (torch.randn(4, 16, 96, generator=torch.Generator().manual_seed(2))
         .to(cuda_device).requires_grad_(True))
    reset_launch_counts()
    with torch.inference_mode():
        sg.run(x)
    assert launch_counts()[primal] == 1 and launch_counts()[residual] == 0
    reset_launch_counts()
    out = sg.run(x)
    s = out[0] if isinstance(out, tuple) else out
    (dx,) = torch.autograd.grad(s.sum(), x)
    counts = launch_counts()
    assert (counts[primal], counts[residual], counts["lif_bwd"]) == (0, 1, 1)
    _, vres = lif_scan.lif_fwd_plain(x.detach())
    assert torch.equal(dx, lif_scan.lif_bwd_plain(vres, torch.ones_like(x)))


@pytest.mark.cuda
def test_cuda_bf16_fire_under_grad_takes_the_bf16_residual_kernels(
        cuda_device):
    x = (torch.randn(2, 16, 96, generator=torch.Generator().manual_seed(3))
         .bfloat16().to(cuda_device).requires_grad_(True))
    reset_launch_counts()
    s = lif_scan.LIFScanSG.run(x)
    (dx,) = torch.autograd.grad(s.float().sum(), x)
    counts = launch_counts()
    assert (counts["lif_bf16"], counts["lif_fwd_bf16"],
            counts["lif_bwd_bf16"], counts["lif_fwd"],
            counts["lif_bwd"]) == (0, 1, 1, 0, 0)
    assert s.dtype == dx.dtype == torch.bfloat16
    _, vres = lif_scan.lif_fwd_plain(x.detach())
    assert torch.equal(dx, lif_scan.lif_bwd_plain(vres, torch.ones_like(x)))


# Row 3's layouts: T across one and many 32-step ring stages (ragged
# ones too), P under one slab, at qwen2-moe's shared experts, ragged past
# them (the TMA ring cannot describe its rows) and at 6144 slabs.
BWD_STEPS = (1, 3, 4, 257, 2048)
BWD_NEURONS = (37, 5632, 5635, 64 * 1024 * 3)


def _bwd_operands(device, t, p, dtype, offset=0):
    """vres (f32, around the threshold) and g of `dtype`, (T, P), their
    data `offset` elements into their buffers."""
    gen = torch.Generator(device=device).manual_seed(7919 * t + p + offset)
    vres = torch.randn(t * p + offset, generator=gen, device=device) * 1.3 \
        + 0.5
    g = torch.randn(t * p + offset, generator=gen, device=device).to(dtype)
    return vres[offset:].view(t, p), g[offset:].view(t, p)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", lif_scan.BWD_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p", BWD_NEURONS)
@pytest.mark.parametrize("t", BWD_STEPS)
def test_cuda_bwd_layouts_match_plain(cuda_device, t, p, dtype, layout):
    """Row 3 in each layout (the stream, the slab ring by TMA, the same
    ring by cp.async) equals its plain version bit for bit, f32 and bf16
    cotangents, soft and hard reset, alpha 2 and 3. The TMA ring refuses
    rows whose pitch is not a multiple of 16 bytes, where the switch
    takes the cp.async ring."""
    vres, g = _bwd_operands(cuda_device, t, p, dtype)
    if layout == "tma_ring" and p % (16 // g.element_size()) != 0:
        with pytest.raises(RuntimeError, match="lif_bwd"):
            lif_scan.lif_bwd_forced(vres, g, layout)
        return
    for soft in (True, False):
        for alpha in (2.0, 3.0):
            kw = dict(decay=0.5, v_th=1.0, soft_reset=soft,
                      surrogate_alpha=alpha)
            dx = lif_scan.lif_bwd_forced(vres, g, layout, **kw)
            assert dx.dtype == dtype
            assert torch.equal(dx, lif_scan.lif_bwd_plain(vres, g, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,p", [(2048, 5632), (257, 37)])
def test_cuda_bwd_unaligned_views_take_the_async_ring(cuda_device, t, p,
                                                      dtype):
    """Views whose data start one element past a 16-byte boundary: the
    TMA ring refuses them, and the switch's pick (the ring at these
    lengths) runs on the cp.async ring, bit for bit with the plain
    version, as does the cp.async ring forced and the stream's scalar
    path."""
    vres, g = _bwd_operands(cuda_device, t, p, dtype, offset=1)
    assert vres.data_ptr() % 16 and g.data_ptr() % 16
    assert lif_scan.bwd_launch(t, p, dtype == torch.bfloat16)["layout"] \
        != "stream"
    with pytest.raises(RuntimeError, match="lif_bwd"):
        lif_scan.lif_bwd_forced(vres, g, "tma_ring")
    for soft in (True, False):
        kw = dict(decay=0.5, v_th=1.0, soft_reset=soft, surrogate_alpha=3.0)
        want = lif_scan.lif_bwd_plain(vres, g, **kw)
        assert torch.equal(lif_scan.lif_bwd(vres, g, **kw), want)
        for layout in ("async_ring", "stream"):
            assert torch.equal(
                lif_scan.lif_bwd_forced(vres, g, layout, **kw), want)


@pytest.mark.cuda
def test_cuda_bwd_switch_takes_the_ring_at_long_t_on_few_neurons(
        cuda_device):
    """The switch's picks as the C library reports them: the TMA slab
    ring for qwen2-moe's shared-expert backward (2048, 5632), 32 neurons
    a block (ten warps: the walker, eight term warps, the producer), 176
    blocks, 32-step stages, 64 KB of ring (60 KB in bf16); the stream for
    SpikingFormer's stage-1 cotangent (4, 32*1024*96) and the LM's hidden
    fire (2, 8*128*5632). Each call is one launch, counted by dtype,
    whatever the layout."""
    for bf16, stages in ((True, 6), (False, 8)):
        ring = lif_scan.bwd_launch(2048, 5632, bf16)
        assert ring == {"layout": "tma_ring", "width": 32, "threads": 320,
                        "grid": 176, "steps": 32, "stages": stages,
                        "sms": ring["sms"]}
    stream = lif_scan.bwd_launch(4, 32 * 1024 * 96, False)
    assert (stream["layout"], stream["width"], stream["threads"]) == \
        ("stream", 4, 128)
    assert lif_scan.bwd_launch(2, 8 * 128 * 5632, True)["layout"] == "stream"
    vres, g = _bwd_operands(cuda_device, 40, 5632, torch.bfloat16)
    reset_launch_counts()
    for layout in lif_scan.BWD_LAYOUTS:
        lif_scan.lif_bwd_forced(vres, g, layout)
    lif_scan.lif_bwd(vres, g.float())
    counts = launch_counts()
    assert (counts["lif_bwd_bf16"], counts["lif_bwd"]) == (3, 1)
    assert sum(counts.values()) == 4


@pytest.mark.cuda
def test_cuda_bwd_kernels_do_not_spill(cuda_device, tmp_path):
    """Every instance of row 3's kernels (the stream, the ring with a TMA
    and with a cp.async producer, f32 and bf16) compiles without a
    register spill (ptxas's report, the library's own flags)."""
    import re
    import subprocess

    from repro_torch.kernels import _build
    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(_build.CSRC / "lif.cu"),
         "-o", str(tmp_path / "lif.o")], capture_output=True, text=True,
        check=True)
    entry, entries = None, 0
    for line in (log.stdout + log.stderr).splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = found.group(1) if "lif_bwd_" in found.group(1) else None
        elif entry and "spill" in line:
            assert re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                             line), (entry, line)
            entries += 1
            entry = None
    assert entries == 3 * 2          # stream, TMA ring, cp.async ring x 2


@pytest.mark.cuda
@pytest.mark.parametrize("p,dw,g", [(64, 12, 2), (256, 14, 4), (64, 13, 8),
                                    (96, 4, 8), (30, 5, 3), (32, 1, 2),
                                    (131072, 14, 2)])
def test_cuda_apec_decompose_kernel_matches_plain(cuda_device, p, dw, g):
    """Every vector width (16-byte, 8-byte, one word), a ragged dw and a
    run-time g; words with the sign bit set included."""
    rng = np.random.default_rng(p * dw + g)
    words = torch.from_numpy(rng.integers(0, 2 ** 32, size=(p, dw),
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    words = words.view(torch.uint32).to(cuda_device)
    got = apec_kernel.apec_decompose_packed(words, g)
    want = apec_kernel.apec_decompose_packed_plain(words, g)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_cuda_apec_decompose_kernel_takes_unaligned_words(cuda_device):
    """A view 4 bytes into its storage cannot take 16-byte vectors."""
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=64 * 8 + 1,
                                         dtype=np.int64).astype(np.int32))
    words = flat.to(cuda_device)[1:].view(64, 8).view(torch.uint32)
    got = apec_kernel.apec_decompose_packed(words, 2)
    want = apec_kernel.apec_decompose_packed_plain(words, 2)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _old_decompose_route(s, g):
    """The dense decompose route before the spike entry: pad C to whole
    words, pack, the word kernel, unpack."""
    c = s.shape[1]
    sp = torch.nn.functional.pad(s, (0, (-c) % 32))
    ov, res = apec_kernel.apec_decompose_packed(pack_spikes(sp).contiguous(),
                                                g)
    return tuple(unpack_spikes_padded(x, c, dtype=s.dtype)
                 for x in (ov, res))


def _spike_view(rng, case, dtype, device):
    """(p, c) spikes on the card, laid out as `case` says; values 0 and 1
    with -0.0, 0.5, 2.0 and NaN mixed in."""
    p, c, layout = case
    vals = torch.tensor([0.0, 1.0, 1.0, -0.0, 0.5, 2.0, float("nan")])
    wide = c + (8 if layout == "strided" else 3 if layout == "stride3" else 0)
    idx = torch.from_numpy(rng.integers(0, len(vals), size=p * wide + 1))
    flat = vals[idx].to(dtype).to(device)
    if layout == "offset1":
        return flat[1:1 + p * c].view(p, c)
    x = flat[:p * wide].view(p, wide)
    return x[:, :c] if layout in ("strided", "stride3") else x


# (p, c, layout): 16-byte vectors (f32 C % 4 == 0, bf16 C % 8 == 0), a
# ragged C, a view one element into its storage, row strides of C + 8
# (still vectors) and C + 3 (scalar), a tail of fewer groups than a block.
# Every P divides by every g below.
SPIKE_CASES = [(480, 384, "contiguous"), (240, 432, "contiguous"),
               (96, 37, "contiguous"), (144, 384, "offset1"),
               (144, 384, "strided"), (144, 96, "stride3"),
               (48, 8, "contiguous")]


@pytest.mark.cuda
@pytest.mark.parametrize("g", [2, 4, 8, 1, 3, 16])
@pytest.mark.parametrize("case", SPIKE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_apec_decompose_spikes_matches_plain(cuda_device, dtype, case,
                                                  g):
    """The spike entry equals its plain version and the old pack route bit
    for bit on every vector path, compile-time and run-time g."""
    s = _spike_view(np.random.default_rng(case[0] + case[1] + g), case,
                    dtype, cuda_device)
    got = apec_kernel.apec_decompose_spikes(s, g)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for a, b, c in zip(got, apec_kernel.apec_decompose_spikes_plain(s, g),
                       _old_decompose_route(s, g)):
        assert a.dtype == dtype and a.is_contiguous()
        assert torch.equal(a.view(bits), b.view(bits))
        assert torch.equal(a.view(bits), c.view(bits))


@pytest.mark.cuda
def test_cuda_apec_decompose_spikes_takes_wide_groups(cuda_device):
    """g = 128 (a run-time bound) at the fc1 width, and the stage-1 patch
    matrix's shape at g = 2."""
    rng = np.random.default_rng(11)
    for p, c, g in ((1024, 384, 128), (131072, 432, 2)):
        s = torch.from_numpy((rng.random((p, c)) < 0.4).astype(np.float32)
                             ).to(cuda_device)
        for a, b in zip(apec_kernel.apec_decompose_spikes(s, g),
                        apec_kernel.apec_decompose_spikes_plain(s, g)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.int32,
                                   torch.float16])
def test_cuda_apec_decompose_spikes_rejects_other_dtypes(cuda_device, dtype):
    s = torch.ones(8, 16, dtype=dtype, device=cuda_device)
    reset_launch_counts()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        apec_kernel.apec_decompose_spikes(s, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.apec_decompose(s, 2)
    assert sum(launch_counts().values()) == 0


@pytest.mark.cuda
def test_cuda_apec_route_is_one_spike_launch_and_no_packing(cuda_device,
                                                           monkeypatch):
    """`core.apec.apec_matmul` on f32 spikes on the card: one spike-entry
    launch, one kernel-18 launch, no `pack_spikes`, `pack_spikes_padded`
    or `unpack_spikes` call."""
    from repro_torch.core import apec
    from repro_torch.core import spikes as core_spikes
    calls = []

    def counted(name, fn):
        def wrap(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrap

    for mod in (core_spikes, ops, spike_matmul):
        for name in ("pack_spikes", "pack_spikes_padded", "unpack_spikes"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name,
                                    counted(name, getattr(mod, name)))
    rng = np.random.default_rng(12)
    s = torch.from_numpy(_clustered(rng, 2 * 512, 384).reshape(2, 512, 384)
                         ).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(384, 96)).astype(np.float32)
                         ).to(cuda_device)
    for g in (2, 4):
        reset_launch_counts()
        with torch.inference_mode():
            out = apec.apec_matmul(s, w, g)
        torch.cuda.synchronize()
        assert {k: v for k, v in launch_counts().items() if v} == \
            {"apec_decompose_spikes": 1, "apec_matmul_csr_pipe": 1}
        assert calls == []
        want = s @ w
        assert (out - want).abs().max().item() <= \
            1e-5 * want.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g", [(256, 256, 128, 2), (260, 200, 40, 4),
                                     (1000, 432, 96, 2), (512, 384, 130, 8),
                                     (1024, 200, 40, 16),
                                     (1024, 300, 70, 128),
                                     (300, 384, 1536, 1)])
@pytest.mark.parametrize("carried", [False, True])
def test_cuda_apec_matmul_csr_kernel_matches_plain(cuda_device, m, k, n, g,
                                                   carried):
    rng = np.random.default_rng(m + n + g)
    s = _clustered(rng, m, k)
    s[128:256] = 0                                # an all-empty m-tile row
    s = torch.from_numpy(s).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                         ).to(cuda_device)
    ov, res = ops.apec_decompose(s, g)
    res, ov = res.contiguous(), ov.contiguous()
    occ = ops.padded_occupancy(s) if carried else None
    csr, occ_r, occ_o = ops.apec_union_worklist(res, ov, g, occ)
    args = (res, ov, w, g, csr, occ_r, occ_o)
    got = spike_matmul.apec_matmul_csr(*args)
    want = spike_matmul.apec_matmul_csr_plain(*args)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    assert torch.all(got[128:256] == 0)
    assert (got - s @ w).abs().max().item() <= tol
    # The event walk is the k-order fmaf chain, bit for bit.
    assert torch.equal(got, spike_matmul.apec_matmul_csr_chain_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g", [(256, 256, 128, 2), (260, 200, 40, 4),
                                     (1000, 432, 96, 2), (512, 384, 130, 8),
                                     (1024, 200, 40, 16),
                                     (1024, 300, 70, 128),
                                     (300, 384, 1536, 1)])
@pytest.mark.parametrize("carried", [False, True])
def test_cuda_apec_pipe_kernels_match_plain_and_serial(cuda_device, m, k, n,
                                                       g, carried):
    """Kernels 18 (f32) and 16 (words) against their plain versions, no
    further from the fp64 product than twice kernels 17 and 15 on the
    same spikes and work list, and equal to each other bit for bit (the
    same A bits and MMAs)."""
    rng = np.random.default_rng(m + n + g)
    s = _clustered(rng, m, k)
    grp = s.reshape(m // g, g, k)
    grp[::3] = grp[::3, :1]                   # overlapping groups
    s = grp.reshape(m, k)
    s[128:256] = 0                            # an all-empty m-tile row
    s = torch.from_numpy(s).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                         ).to(cuda_device)
    occ = ops.padded_occupancy(s) if carried else None
    ov, res = ops.apec_decompose(s, g)
    res, ov = res.contiguous(), ov.contiguous()
    exact = s.double() @ w.double()
    args = (res, ov, w, g) + ops.apec_union_worklist(res, ov, g, occ)
    got = spike_matmul.apec_matmul_csr_pipe(*args)
    want = spike_matmul.apec_matmul_csr_pipe_plain(*args)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    assert _within_twice(got, spike_matmul.apec_matmul_csr(*args), exact)
    assert torch.all(got[128:256] == 0)
    ov_p, res_p = apec_kernel.apec_decompose_packed(pack_spikes_padded(s), g)
    pargs = (res_p, ov_p, w, g) + ops.apec_union_worklist(
        res_p, ov_p, g, occ, packed=True)
    got_p = spike_matmul.apec_matmul_packed_csr_pipe(*pargs)
    want_p = spike_matmul.apec_matmul_packed_csr_pipe_plain(*pargs)
    assert (got_p - want_p).abs().max().item() <= tol
    assert _within_twice(got_p, spike_matmul.apec_matmul_packed_csr(*pargs),
                         exact)
    assert torch.equal(got_p, got)
    # Kernels 17 and 15 on the same spikes: the same walk, bit for bit.
    assert torch.equal(spike_matmul.apec_matmul_packed_csr(*pargs),
                       spike_matmul.apec_matmul_csr(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g", [(256, 256, 128, 2), (1000, 432, 96, 2),
                                     (1024, 300, 70, 16)])
def test_cuda_apec_pipe_kernel_takes_integer_counts(cuda_device, m, k, n, g):
    """Kernel 18 on f32 operands holding spike counts 0..3 (exact in
    bf16, so every product stays exact): within the contract of its plain
    version and within twice kernel 17's distance from the fp64
    product."""
    rng = np.random.default_rng(m + k + g)
    res = _clustered(rng, m, k) * rng.integers(1, 4, size=(m, k))
    ov = _clustered(rng, m // g, k) * rng.integers(1, 4, size=(m // g, k))
    res = torch.from_numpy(res.astype(np.float32)).to(cuda_device)
    ov = torch.from_numpy(ov.astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                         ).to(cuda_device)
    args = (res, ov, w, g) + ops.apec_union_worklist(res, ov, g)
    got = spike_matmul.apec_matmul_csr_pipe(*args)
    want = spike_matmul.apec_matmul_csr_pipe_plain(*args)
    assert (got - want).abs().max().item() <= \
        1e-5 * want.abs().max().item() + 1e-5
    exact = res.double() @ w.double() + (ov.double() @ w.double()
                                          ).repeat_interleave(g, 0)
    assert _within_twice(got, spike_matmul.apec_matmul_csr(*args), exact)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,launches", [
    ("cuda-pipe", {"apec_decompose_spikes": 1, "apec_matmul_csr_pipe": 1}),
    ("cuda", {"apec_decompose_spikes": 1, "apec_matmul_csr": 1}),
    ("cuda-pred", {"apec_decompose_spikes": 1, "spike_matmul_pred": 2})])
def test_cuda_apec_route_launches_each_kernel_once(cuda_device, backend,
                                                   launches):
    rng = np.random.default_rng(3)
    s = torch.from_numpy(_clustered(rng, 2 * 300, 200).reshape(2, 300, 200)
                         ).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(200, 70)).astype(np.float32)
                         ).to(cuda_device)
    for g in (2, 4):
        reset_launch_counts()
        with dispatch.use_backend(backend, op="apec_matmul"):
            out = dispatch.apec_matmul(s, w, g=g)
        counts = launch_counts()
        assert {k: v for k, v in counts.items() if v} == launches
        want = s @ w
        assert (out - want).abs().max().item() <= \
            1e-5 * want.abs().max().item() + 1e-5


# ------------------------------------------------------ packed payload
@pytest.mark.cuda
@pytest.mark.parametrize("k", [48, 96, 200, 37])
def test_cuda_packed_fire_matches_plain(cuda_device, k):
    """Words and counts exactly, and the words equal the packed spikes of
    the counts-mode kernel on the same drive."""
    x = (torch.randn(4, 64, k, generator=torch.Generator().manual_seed(k))
         + 0.3).to(cuda_device)
    words, cnt = lif_scan.lif_counts_packed(x, decay=0.5, v_th=0.5)
    pw, pcnt = lif_scan.lif_counts_packed_plain(x, decay=0.5, v_th=0.5)
    assert words.dtype == torch.uint32 and words.shape == (4, 64, -(-k // 32))
    assert torch.equal(words.view(torch.int32), pw.view(torch.int32))
    assert torch.equal(cnt, pcnt)
    s, _ = lif_scan.lif_counts(x, decay=0.5, v_th=0.5)
    assert torch.equal(words.view(torch.int32),
                       pack_spikes_padded(s).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 256, 128), (300, 200, 60),
                                   (1000, 384, 96), (260, 576, 40)])
def test_cuda_packed_csr_kernel_matches_plain_and_kernel_11(cuda_device, m,
                                                            k, n):
    """On the same spikes and k order the packed kernel's sums are kernel
    11's, bit for bit."""
    rng = np.random.default_rng(m + k)
    s = _clustered(rng, m, k)
    s[128:256] = 0                                # an all-empty m-tile row
    s = torch.from_numpy(s).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                         ).to(cuda_device)
    p = pack_spikes_padded(s)
    csr = build_csr(ragged_packed_tile_occupancy(p, 128, 128), 128, 128)
    got = spike_matmul.spike_matmul_packed_csr(p, w, csr)
    want = spike_matmul.spike_matmul_packed_csr_plain(p, w, csr)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got, spike_matmul.spike_matmul_csr(s, w, csr))
    assert torch.all(got[128:256] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g", [(256, 256, 128, 2), (260, 200, 40, 4),
                                     (1000, 432, 96, 2), (512, 384, 130, 8),
                                     (1024, 200, 40, 16),
                                     (1024, 300, 70, 128),
                                     (300, 384, 1536, 1)])
@pytest.mark.parametrize("carried", [False, True])
def test_cuda_packed_apec_kernel_matches_plain(cuda_device, m, k, n, g,
                                               carried):
    rng = np.random.default_rng(m + n + g)
    s = _clustered(rng, m, k)
    s[128:256] = 0
    s = torch.from_numpy(s).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)
                         ).to(cuda_device)
    p = pack_spikes_padded(s)
    ov, res = apec_kernel.apec_decompose_packed(p, g)
    occ = ops.padded_occupancy(s) if carried else None
    csr, occ_r, occ_o = ops.apec_union_worklist(res, ov, g, occ, packed=True)
    args = (res, ov, w, g, csr, occ_r, occ_o)
    got = spike_matmul.apec_matmul_packed_csr(*args)
    want = spike_matmul.apec_matmul_packed_csr_plain(*args)
    tol = 1e-5 * want.abs().max().item() + 1e-5
    assert (got - want).abs().max().item() <= tol
    assert (got - s @ w).abs().max().item() <= tol
    assert torch.all(got[128:256] == 0)
    assert torch.equal(
        got, spike_matmul.apec_matmul_packed_csr_chain_plain(*args))
    k = w.shape[0]
    assert torch.equal(got, spike_matmul.apec_matmul_csr(
        unpack_spikes_padded(res, k).contiguous(),
        unpack_spikes_padded(ov, k).contiguous(), w, g, csr, occ_r, occ_o))


@pytest.mark.cuda
def test_cuda_packed_routes_launch_their_kernels(cuda_device):
    """A packed EventTensor on the card resolves to `cuda-packed-pipe`
    and launches the word kernels, once per call; a dense call does not
    (it resolves to `cuda-pipe`), APEC included; the serial routes stay
    reachable by override."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(_clustered(rng, 512, 96)).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(96, 70)).astype(np.float32)
                         ).to(cuda_device)
    wc = torch.from_numpy(rng.normal(size=(3, 3, 96, 8)).astype(np.float32)
                          ).to(cuda_device)
    et = EventTensor.from_spikes(s, pack=True)
    assert dispatch.resolved_backends(cuda_device, packed=True)[
        "spike_matmul"] == dispatch.CUDA_PACKED_PIPE
    assert dispatch.resolved_backends(cuda_device)["spike_matmul"] == \
        dispatch.CUDA_PIPE

    def serial(fn, name, op="spike_matmul"):
        def run():
            with dispatch.use_backend(name, op=op):
                return fn()
        return run
    cases = ((lambda: dispatch.spike_matmul(et, w), s @ w,
              {"spike_matmul_packed_csr_pipe": 1}),
             (lambda: dispatch.apec_matmul(et, w, g=2), s @ w,
              {"apec_decompose": 1, "apec_matmul_packed_csr_pipe": 1}),
             (lambda: dispatch.apec_matmul(s, w, g=2), s @ w,
              {"apec_decompose_spikes": 1, "apec_matmul_csr_pipe": 1}),
             (lambda: dispatch.econv(et.reshape(8, 8, 8, 96), wc),
              dispatch.get_backend("econv", "ref").fn(s.reshape(8, 8, 8, 96),
                                                      wc),
              {"spike_matmul_packed_csr_pipe": 1}),
             (lambda: dispatch.spike_matmul(s, w), s @ w,
              {"spike_matmul_csr_pipe": 1}),
             (serial(lambda: dispatch.spike_matmul(et, w),
                     dispatch.CUDA_PACKED), s @ w,
              {"spike_matmul_packed_csr": 1}),
             (serial(lambda: dispatch.spike_matmul(s, w), dispatch.CUDA),
              s @ w, {"spike_matmul_csr": 1}),
             (serial(lambda: dispatch.apec_matmul(et, w, g=2),
                     dispatch.CUDA_PACKED, op="apec_matmul"), s @ w,
              {"apec_decompose": 1, "apec_matmul_packed_csr": 1}),
             (serial(lambda: dispatch.apec_matmul(s, w, g=2), dispatch.CUDA,
                     op="apec_matmul"), s @ w,
              {"apec_decompose_spikes": 1, "apec_matmul_csr": 1}))
    for fn, want, launches in cases:
        reset_launch_counts()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        assert {k: v for k, v in launch_counts().items() if v} == launches
        assert (out - want).abs().max().item() <= \
            1e-4 * want.abs().max().item() + 1e-4


# ------------------------------------------------------------ the LM path
@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,dw", [(256, 1024, 2), (32, 32768, 2),
                                     (7, 1000, 2), (3, 1, 1), (5, 77, 3)])
def test_cuda_sdsa_causal_kernel_matches_plain(cuda_device, bh, n, dw):
    """Bits at 1/(4N) per bit, so a column's first bit falls anywhere in
    the sequence and the prefix-OR does not saturate after the first
    chunk: later chunks still turn bits on, and the carry across them is
    checked."""
    g = torch.Generator().manual_seed(n + dw)
    bits = (torch.rand((bh, n, 32 * dw), generator=g) < 1 / (4 * n)).float()
    kv = pack_spikes(bits).to(cuda_device)
    got = sdsa_kernel.sdsa_causal_status(kv)
    want = sdsa_kernel.sdsa_causal_status_plain(kv)
    assert not bool((want == 0xFFFFFFFF).all())
    if n >= 1024:
        late = want[:, n // 2:].view(torch.int32)
        assert bool((late != want[:, n // 2 - 1:-1].view(torch.int32)).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 1024, 2048), (2, 8, 1000),
                                   (2, 37)])
def test_cuda_lif_bf16_kernel_matches_plain(cuda_device, shape):
    g = torch.Generator().manual_seed(len(shape))
    x = (torch.randn(shape, generator=g) * 0.8 + 0.6).bfloat16()
    x.view(-1)[:6] = torch.tensor([1.0, 0.5, 2.0, 0.99609375, 1.0078125, 0])
    x = x.to(cuda_device).reshape(shape[0], -1)
    reset_launch_counts()
    got = lif_scan.lif(x)
    assert launch_counts()["lif_bf16"] == 1 and launch_counts()["lif"] == 0
    want = lif_scan.lif_plain(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_causal_sdsa_route_launches_the_kernel(cuda_device):
    g = torch.Generator().manual_seed(4)
    q, k, v = ((torch.rand((2, 2, 4, 300, 64), generator=g) < 0.2)
               .bfloat16().to(cuda_device) for _ in range(3))
    assert dispatch.resolve_attribution("causal_sdsa", q, k, v) == "cuda"
    reset_launch_counts()
    got = dispatch.causal_sdsa(q, k, v)
    assert launch_counts()["sdsa_causal"] == 1
    with dispatch.use_backend("ref"):
        want = dispatch.causal_sdsa(q, k, v)
    assert torch.equal(got, want)


# ---------------------------------- the SDSA spike entries (TPU rows 7-9)
def _head_view(g, shape, p, dtype, device, offset=0):
    """(T, B, N, H, dh) spikes at rate p -> the models' (T, B, H, N, dh)
    view; `offset` elements into its storage (the scalar path)."""
    n = int(np.prod(shape))
    flat = torch.zeros(offset + n, dtype=dtype)
    flat[offset:] = (torch.rand(n, generator=g) < p).to(dtype)
    return flat.to(device)[offset:].view(shape).transpose(2, 3)


# (name, (T, B, N, H, dh), dtype, kv rate, offset): SpikingFormer-4-384's
# SSA, the LM's prefill, a ragged N, the 32k row, the scalar path.
SPIKE_CASES = [
    ("spikingformer", (4, 32, 64, 8, 48), torch.float32, 0.3, 0),
    ("lm_prefill", (2, 8, 1024, 32, 64), torch.bfloat16, 1 / 4096, 0),
    ("ragged_n1000", (2, 2, 1000, 32, 64), torch.bfloat16, 1 / 4000, 0),
    ("n32768", (2, 1, 32768, 32, 64), torch.bfloat16, 1 / 131072, 0),
    ("f32_lm", (2, 2, 777, 4, 64), torch.float32, 1 / 3000, 0),
    ("unaligned", (2, 2, 300, 3, 40), torch.bfloat16, 1 / 1200, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype,p,offset", SPIKE_CASES)
def test_cuda_sdsa_spike_entries_match_plain(cuda_device, name, shape,
                                             dtype, p, offset):
    """Both spike entries on the models' head-transposed views equal their
    plain versions bit for bit; kv at a low rate, so the causal status
    still changes in the last chunks (checked) and the look-back's carry
    across every chunk is held. The outputs keep q's layout."""
    g = torch.Generator().manual_seed(len(name))
    q = _head_view(g, shape, 0.3, dtype, cuda_device, offset)
    k, v = (_head_view(g, shape, p ** 0.5, dtype, cuda_device, offset)
            for _ in range(2))
    reset_launch_counts()
    got = sdsa_kernel.causal_sdsa_spikes(q, k, v)
    assert launch_counts()["sdsa_causal"] == 1
    want = sdsa_kernel.causal_sdsa_spikes_plain(q, k, v)
    status = ((k != 0) & (v != 0)).any(0).to(torch.uint8).cummax(-2).values
    assert shape[2] < 512 or bool(
        (status[..., -1, :] > status[..., shape[2] // 2, :]).any())
    assert got.stride() == q.stride() and got.dtype == dtype
    assert torch.equal(got, want)
    got = sdsa_kernel.sdsa_or_spikes(q, k, v)
    assert launch_counts()["sdsa_or"] == 1
    assert got.stride() == q.stride()
    assert torch.equal(got, sdsa_kernel.sdsa_or_spikes_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype,p,offset", SPIKE_CASES)
def test_cuda_sdsa_status_entries_match_plain(cuda_device, name, shape,
                                              dtype, p, offset):
    """The status-only instance (`ops.sdsa_status`, row 7 alone) on the
    models' head-transposed K and V views and on their words: one launch
    each, bit for bit with the plain versions, in k's dtype, contiguous."""
    g = torch.Generator().manual_seed(len(name) + 1)
    k, v = (_head_view(g, shape, p ** 0.5, dtype, cuda_device, offset)
            for _ in range(2))
    reset_launch_counts()
    got = ops.sdsa_status(k, v)
    assert launch_counts()["sdsa_status"] == 1
    want = sdsa_kernel.sdsa_status_spikes_plain(k, v)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    n, d = shape[2], shape[4]
    kw, vw = (pack_spikes_padded(x.contiguous().reshape(-1, n, d))
              for x in (k, v))
    words = sdsa_kernel.sdsa_status_words(kw, vw)
    assert launch_counts()["sdsa_status"] == 2
    assert torch.equal(words.view(torch.int32),
                       sdsa_kernel.sdsa_status_words_plain(kw, vw)
                       .view(torch.int32))


@pytest.mark.cuda
def test_cuda_sdsa_status_of_no_tokens_is_zero(cuda_device):
    k = torch.ones(2, 3, 0, 40, device=cuda_device)
    assert torch.equal(sdsa_kernel.sdsa_status_spikes(k, k),
                       torch.zeros(2, 3, 40, device=cuda_device))


@pytest.mark.cuda
def test_cuda_sdsa_entries_refuse_what_the_kernels_cannot_take(cuda_device):
    x = torch.zeros(2, 3, 8, 40, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        sdsa_kernel.sdsa_or_spikes(x, x, x.bfloat16())
    with pytest.raises(ValueError, match="unit-stride channel"):
        y = x.transpose(2, 3)
        sdsa_kernel.causal_sdsa_spikes(y, y, y)
    with pytest.raises(RuntimeError, match="autograd"):
        z = x.clone().requires_grad_()
        sdsa_kernel.sdsa_or_spikes(z, z, z)


@pytest.mark.cuda
@pytest.mark.parametrize("op,shape,dtype", [
    ("sdsa", (4, 32, 64, 8, 48), torch.float32),
    ("causal_sdsa", (2, 8, 1024, 32, 64), torch.bfloat16),
    ("causal_sdsa", (2, 2, 333, 32, 64), torch.float32)])
def test_cuda_sdsa_route_is_one_launch_and_no_packing(cuda_device,
                                                      monkeypatch, op,
                                                      shape, dtype):
    """`dispatch.sdsa` / `dispatch.causal_sdsa` on the card: one kernel
    launch a call, no `pack_spikes`, `pack_spikes_padded` or
    `unpack_spikes` call, and the registry's `ref` on the same inputs."""
    from repro_torch.core import spikes as core_spikes
    calls = []

    def counted(name, fn):
        def wrap(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrap

    for mod in (core_spikes, ops):
        for name in ("pack_spikes", "pack_spikes_padded", "unpack_spikes"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name,
                                    counted(name, getattr(mod, name)))
    g = torch.Generator().manual_seed(len(shape))
    q, k, v = (_head_view(g, shape, 0.2, dtype, cuda_device)
               for _ in range(3))
    if op == "sdsa":
        q = q.flatten(0, 1)          # (T*B, H, N, dh): the folded SSA call
        k, v = k.flatten(0, 1), v.flatten(0, 1)
    assert dispatch.resolve_attribution(op, q, k, v) == "cuda"
    reset_launch_counts()
    with torch.inference_mode():
        got = getattr(dispatch, op)(q, k, v)
    counts = launch_counts()
    kernel = "sdsa_or" if op == "sdsa" else "sdsa_causal"
    assert counts[kernel] == 1 and sum(counts.values()) == 1
    assert calls == []
    with dispatch.use_backend("ref"):
        want = getattr(dispatch, op)(q, k, v)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- hybrid
def _gated_cases(rng, dev):
    """(label, call(route, out)) for the three gated kernels: 10 (its
    stream path at N = 16 and its wide path), 11 and 17 on clustered
    spikes, ragged shapes included."""
    cases = []
    for m, k, n in ((1024, 384, 1536), (2048, 1536, 384), (4096, 288, 16),
                    (1000, 300, 50)):
        s = torch.from_numpy(_clustered(rng, m, k)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(
            np.float32)).to(dev)
        occ = ops.padded_occupancy(s)
        csr = build_csr(occ, 128, 128)
        cases.append((f"k10-{m}x{k}x{n}", lambda r, o, s=s, w=w, occ=occ:
                      spike_matmul.spike_matmul_pred(s, w, occ, route=r,
                                                     out=o)))
        cases.append((f"k11-{m}x{k}x{n}", lambda r, o, s=s, w=w, csr=csr:
                      spike_matmul.spike_matmul_csr(s, w, csr, route=r,
                                                    out=o)))
        if m % 256 == 0:
            ov, res = ops.apec_decompose(s, 2)
            work = ops.apec_union_worklist(res, ov, 2, occ)
            cases.append((f"k17-{m}x{k}x{n}", lambda r, o, res=res, ov=ov,
                          w=w, work=work: spike_matmul.apec_matmul_csr(
                              res, ov, w, 2, *work, route=r, out=o)))
    return cases


@pytest.mark.cuda
def test_cuda_gated_kernels_null_on_off(cuda_device):
    """Rows 10, 11 and 17 with the gate null, on and off: on equals null
    bit for bit, off leaves a sentinel-filled output untouched, and each
    gated call counts one launch."""
    rng = np.random.default_rng(0)
    flags = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    for label, call in _gated_cases(rng, cuda_device):
        ref = call(None, None)
        on = torch.full_like(ref, float("nan"))
        off = torch.full_like(ref, 12345.0)
        reset_launch_counts()
        call(flags[0:1], on)
        call(flags[1:2], off)
        torch.cuda.synchronize()
        assert sum(launch_counts().values()) == 2, label
        assert torch.equal(on, ref), label
        assert bool((off == 12345.0).all()), label


@pytest.mark.cuda
def test_cuda_device_route_flag_equals_host_decision(cuda_device):
    from repro_torch.core import costmodel
    rng = np.random.default_rng(1)
    for mt, kt in ((64, 12), (64, 3), (1024, 4), (8, 48), (1, 32)):
        for op in dispatch.HYBRID_OPS:
            thresh = costmodel.hybrid_event_bucket_threshold(op, mt, kt)
            for p in (0.0, 0.002, 0.02, 0.2, 0.6, 1.0):
                occ = torch.from_numpy((rng.random((mt, kt)) < p).astype(
                    np.int32)).to(cuda_device)
                count = int((occ > 0).sum())
                rep = costmodel.bucket_representative(
                    costmodel.pow2_bucket(count), mt * kt)
                event = costmodel.event_route_wins(op, rep, mt, kt)
                flags = ops.hybrid_route(occ, thresh)
                assert flags.tolist() == [int(event), int(not event)], \
                    (op, mt, kt, count)


def _sync_count(run):
    """The host syncs `run` makes, counted by the sync debug mode."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in got)


@pytest.mark.cuda
def test_cuda_hybrid_forward_adds_no_host_sync(cuda_device):
    """A hybrid SpikingFormer forward under the sync debug mode makes no
    host sync that the automatic forward does not make, and equals it
    bit for bit."""
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.models import spikingformer as sf
    params = sf.spikingformer_init(2, 64, generator=torch.Generator()
                                   .manual_seed(0), device=cuda_device)
    x = torch.rand((4, 32, 32, 3),
                   generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    out = {}

    def run(hybrid):
        cfg = SpikingConfig(t_steps=2, lif_vth=0.5, hybrid=hybrid)
        with torch.inference_mode():
            out[hybrid] = sf.spikingformer_apply(params, x, n_heads=4,
                                                 spiking_cfg=cfg)
    run(True), run(False)                 # warm: build, caches
    assert _sync_count(lambda: run(True)) <= _sync_count(lambda: run(False))
    assert torch.equal(out[True], out[False])


@pytest.mark.cuda
def test_cuda_hybrid_graph_takes_the_route_of_the_replayed_map(cuda_device):
    """One CUDA graph of a hybrid spike_matmul on an (8, 48) map, whose
    threshold lies inside its buckets, replayed on a sparse map and a full
    map: the device flag matches `event_route_wins` for each, and the
    output the replayed route's."""
    from repro_torch.core import costmodel
    mt, kt = 8, 48
    thresh = costmodel.hybrid_event_bucket_threshold("spike_matmul", mt, kt)
    assert 0 <= thresh < costmodel.num_buckets(mt * kt) - 1
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((kt * 128, 384)).astype(
        np.float32)).to(cuda_device)

    def spikes(n_live):
        live = np.zeros(mt * kt, bool)
        live[rng.permutation(mt * kt)[:n_live]] = True
        mask = np.kron(live.reshape(mt, kt), np.ones((128, 128), bool))
        return torch.from_numpy(((rng.random(mask.shape) < 0.5) & mask)
                                .astype(np.float32)).to(cuda_device)
    sparse, full = spikes(1), spikes(mt * kt)
    s = sparse.clone()
    occ = ops.padded_occupancy(s)
    with dispatch.use_hybrid():
        be, attr = dispatch.resolve_with_attribution("spike_matmul", s, w,
                                                     occupancy=occ)
    assert attr == f"hybrid[cuda|cuda-pred@b{thresh}]"
    holder = {}

    def call():
        holder["flags"] = ops.hybrid_route(occ, thresh)
        holder["out"] = be.fn(s, w, occupancy=occ)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph):
        call()
    for src in (sparse, full, sparse):
        s.copy_(src)
        occ.copy_(ops.padded_occupancy(src))
        graph.replay()
        torch.cuda.synchronize()
        count = int((occ > 0).sum())
        event = costmodel.event_route_wins(
            "spike_matmul", costmodel.bucket_representative(
                costmodel.pow2_bucket(count), mt * kt), mt, kt)
        assert holder["flags"].tolist() == [int(event), int(not event)]
        ref = spike_matmul.spike_matmul_pred_plain(src, w, occ)
        err = (holder["out"] - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item() + 1e-5
