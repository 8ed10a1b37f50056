"""The attention-family LM architectures in repro_torch against the JAX
package, on the CPU: training and serving. `loss_fn` and every gradient
leaf (qwen2-moe, phi-3-vision with its frontend labels, whisper through
its encoder, qwen3 with leaves SDSA never reads), `make_train_step` on
those unread leaves, the port's `Server` against the reference's on
reduced qwen2-moe and reduced xlstm-350m, the MoE decode step's coupling
of the slots and the spiking xLSTM's silent stream, reference findings.
Configs, params and inputs as in `tests/test_torch_lm_archs.py`, whose
helpers this file imports.

Tolerances:
  * f32 trees: losses within 1e-5 relative, every gradient leaf within
    1e-5 * max|leaf| + 1e-7, logits within 1e-5 of max|ref|; the xLSTM's
    hidden states within 2^-8 of max|ref| (SSM_F32_TOL, for the reason
    given there);
  * served tokens (f32 trees): equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw
from repro_torch.kernels import dispatch
from test_torch_lm_archs import F32_TOL, SSM_F32_TOL, _cfgs, _close, _f, \
    _inputs, _trees

torch.set_num_threads(2)


# -------------------------------------------------------------- training
@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "phi-3-vision-4.2b",
                                  "whisper-medium", "qwen3-4b"))
def test_loss_fn_and_every_gradient_leaf_match_repro(arch, spiking):
    """f32 trees. phi-3-vision's frontend positions carry label -1;
    whisper's gradients reach the encoder through the cross K / V;
    qwen3's qk-norm scales, which SDSA never reads, get zeros."""
    jc, tc = _cfgs(arch)
    jp, tp0 = _trees(arch, "f32")
    _, jb, tb = _inputs(jc, "f32", seq=8)
    want, jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, jb, spiking))(jp)
    tp = jax.tree.map(lambda t: t.clone(), tp0,
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    got = tlm.loss_fn(tc, tp, tb, spiking)
    grads = torch.autograd.grad(got, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_TOL)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for i, (a, b) in enumerate(zip(grads, jl)):
        b = _f(b)
        err = np.abs(_f(a) - b).max()
        bound = F32_TOL * np.abs(b).max() + 1e-7
        assert err <= bound, f"leaf {i} {b.shape}: {err} > {bound}"


def _vth(cfg, v_th):
    return cfg.replace(spiking=dataclasses.replace(cfg.spiking, lif_vth=v_th))


def _grads_of(fn_loss, tp0):
    """(loss, gradients) of the port's loss on a fresh copy of tp0, every
    leaf a gradient (zeros where the loss never reads it)."""
    tp = jax.tree.map(lambda t: t.clone(), tp0,
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    got = fn_loss(tp)
    return got, torch.autograd.grad(got, leaves, allow_unused=True,
                                    materialize_grads=True)


def _leaves_close(grads, jgrads, tol):
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for i, (a, b) in enumerate(zip(grads, jl)):
        b = _f(b)
        err = np.abs(_f(a) - b).max()
        bound = tol * np.abs(b).max() + 1e-7
        assert err <= bound, f"leaf {i} {b.shape}: {err} > {bound}"


SSM_GRAD_CASES = [(n, s) for n in ("jamba-1.5-large-398b", "jamba-no-moe",
                                    "xlstm-350m") for s in (True, False)] \
    + [("xlstm-350m-vth-0.02", True)]


@pytest.mark.parametrize(
    "name,spiking", SSM_GRAD_CASES,
    ids=[f"{n}-{'spiking' if s else 'dense'}" for n, s in SSM_GRAD_CASES])
def test_ssm_loss_fn_and_every_gradient_leaf_match_repro(name, spiking):
    """f32 trees, the SSM configs: the loss and every gradient leaf
    against `jax.value_and_grad` within SSM_F32_TOL (each scan step
    rounds its output to bf16, so an f32 reduction's order can move a
    whole bf16 step). The sLSTM's `ln2` and `mlp`, which its "none" FFN
    never applies, get zero gradients in both packages; at the xLSTM's
    lif_vth 1.0 the spiking stream is silent, at 0.02 it fires."""
    if name == "xlstm-350m-vth-0.02":
        jc, tc = (_vth(c, 0.02) for c in _cfgs("xlstm-350m"))
        jp, tp0 = _trees("xlstm-350m", "f32")
    else:
        jc, tc = _cfgs(name)
        jp, tp0 = _trees(name, "f32")
    _, jb, tb = _inputs(jc, "f32", seq=8)
    want, jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, jb, spiking))(jp)
    got, grads = _grads_of(lambda tp: tlm.loss_fn(tc, tp, tb, spiking), tp0)
    np.testing.assert_allclose(got.item(), float(want), rtol=SSM_F32_TOL)
    _leaves_close(grads, jgrads, SSM_F32_TOL)
    if tc.xlstm is not None:
        slstm = tp0["blocks"][tc.xlstm.slstm_index]
        ids = {id(t) for t in adamw.leaves([slstm["ln2"], slstm["mlp"]])}
        unread = [i for i, t in enumerate(adamw.leaves(tp0)) if id(t) in ids]
        assert len(unread) == 4        # ln2 and the MLP's three matrices
        for i in unread:
            assert not grads[i].any()
            assert not np.any(_f(jax.tree_util.tree_leaves(jgrads)[i]))


def test_train_step_gives_unread_leaves_zero_gradients():
    """Reduced qwen3 in spiking mode: SDSA never reads the qk-norm scales,
    so autograd has no gradient for them; `make_train_step` gives them
    zeros (as jax.grad does) and takes its step."""
    _, tc = _cfgs("qwen3-4b")
    _, tp0 = _trees("qwen3-4b", "f32")
    tp = jax.tree.map(lambda t: t.clone(), tp0,
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    _, _, tb = _inputs(tc, "f32", seq=8)
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tlm.loss_fn(tc, tp, tb, True)
    raw = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert sum(g is None for g in raw) == 2    # q_norm, k_norm
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    step = tsteps.make_train_step(tc, opt_cfg, spiking=True)
    _, _, metrics = step(tp, adamw.init(tp, opt_cfg), tb)
    assert metrics["loss"].item() == loss.item()
    assert torch.isfinite(metrics["grad_norm"])


# ---------------------------------------------------------------- serving
class TickClock(tserve.FakeClock):
    def __init__(self, tick: float = 0.004):
        super().__init__()
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def _serve(srv, req_type, trace, only=None):
    reqs = [req_type(rid=t.rid, prompt=list(t.prompt), max_new=t.max_new)
            for t in trace]
    for r, t in zip(reqs, trace):
        if only is None or r.rid in only:
            srv.submit_at(r, t.arrival_s if only is None else 0.0)
    while srv.step() or srv.pending or srv.arrivals:
        pass
    return [r.generated for r in reqs if only is None or r.rid in only]


@pytest.mark.parametrize("spiking", [True, False], ids=["spiking", "dense"])
def test_moe_server_serves_the_reference_servers_tokens(spiking):
    """Reduced qwen2-moe on 4 slots: the port's Server and the reference's
    on the same f32 tree and bursty trace give the same tokens, and so do
    requests 0 and 3 served alone. Alone against in the pool, the two
    packages agree request by request: an MoE decode step routes every
    slot's tokens together (capacity drops), and the spiking shared
    experts' fire scans the step's flattened tokens as time steps, so a
    request's tokens may depend on its pool (a reference finding)."""
    from benchmarks.serve_traces import make_trace
    jc, tc = _cfgs("qwen2-moe-a2.7b")
    jp, tp = _trees("qwen2-moe-a2.7b", "f32")
    trace = make_trace("bursty", seed=1, n_requests=5, vocab=tc.vocab,
                       prompt_len=(3, 9), max_new=(3, 6), burst_size=3,
                       burst_gap_s=0.02)
    runs = {}
    for pkg, server, req in (("t", tserve.Server, tserve.Request),
                             ("j", jserve.Server, jserve.Request)):
        kw = {"device": "cpu"} if pkg == "t" else {}
        for only in (None, (0,), (3,)):
            srv = server(tc if pkg == "t" else jc, n_slots=4, max_seq=32,
                         spiking=spiking, clock=TickClock(), **kw)
            srv.params = tp if pkg == "t" else jp
            runs[pkg, only] = _serve(srv, req, trace, only)
    assert runs["t", None] == runs["j", None]
    assert all(len(g) > 0 for g in runs["t", None])
    for i in (0, 3):
        assert runs["t", (i,)] == runs["j", (i,)]
        assert (runs["t", (i,)][0] == runs["t", None][i]) == \
            (runs["j", (i,)][0] == runs["j", None][i])
    if spiking:     # request 3 decodes other tokens alone, in both
        assert runs["j", (3,)][0] != runs["j", None][3]


def test_moe_decode_step_couples_the_slots_in_both_packages():
    """Reference finding, spiking reduced qwen2-moe: changing slot 1's
    token changes slot 0's logits in one decode step, in the reference as
    in the port (the shared experts' fire runs its membrane across the
    step's T x B flattened tokens)."""
    jc, tc = _cfgs("qwen2-moe-a2.7b")
    jp, tp = _trees("qwen2-moe-a2.7b", "f32")
    out = {}
    for other in (5, 6):
        toks = np.array([3, other])
        jst = jlm.init_decode_state(jc, 2, 8, True)
        tst = tlm.init_decode_state(tc, 2, 8, True, device="cpu")
        jl, _ = jlm.decode_step(jc, jp, jst, jnp.asarray(toks), 0, True)
        with torch.inference_mode():
            tl, _ = tlm.decode_step(tc, tp, tst, torch.from_numpy(toks), 0,
                                    True)
        _close(tl, jl, F32_TOL)
        out[other] = (_f(tl)[0], _f(jl)[0])
    assert not np.array_equal(out[5][0], out[6][0])
    assert not np.array_equal(out[5][1], out[6][1])


@pytest.mark.parametrize("mode", ["dense", "spiking", "spiking-vth-0.02"])
def test_xlstm_server_serves_the_reference_servers_tokens(mode):
    """Reduced xlstm-350m on 4 slots: the port's Server and the
    reference's on the same f32 tree and bursty trace give the same
    tokens, and requests 0 and 3 served alone decode their pool tokens in
    both packages: an SSM decode state is per slot and nothing couples
    the slots. Spiking at the config's threshold 1.0 the stream is silent
    (see the next test) and every request decodes token 0; at 0.02 it
    fires."""
    from benchmarks.serve_traces import make_trace
    jc, tc = _cfgs("xlstm-350m")
    jp, tp = _trees("xlstm-350m", "f32")
    spiking = mode != "dense"
    if mode == "spiking-vth-0.02":
        jc, tc = _vth(jc, 0.02), _vth(tc, 0.02)
    trace = make_trace("bursty", seed=1, n_requests=5, vocab=tc.vocab,
                       prompt_len=(3, 9), max_new=(3, 6), burst_size=3,
                       burst_gap_s=0.02)
    runs = {}
    for pkg, server, req in (("t", tserve.Server, tserve.Request),
                             ("j", jserve.Server, jserve.Request)):
        kw = {"device": "cpu"} if pkg == "t" else {}
        for only in (None, (0,), (3,)):
            srv = server(tc if pkg == "t" else jc, n_slots=4, max_seq=32,
                         spiking=spiking, clock=TickClock(), **kw)
            srv.params = tp if pkg == "t" else jp
            runs[pkg, only] = _serve(srv, req, trace, only)
    assert runs["t", None] == runs["j", None]
    assert all(len(g) > 0 for g in runs["t", None])
    for i in (0, 3):
        assert runs["t", (i,)] == runs["j", (i,)]
        assert runs["t", (i,)][0] == runs["t", None][i]
    tokens = {t for g in runs["t", None] for t in g}
    assert (tokens == {0}) == (mode == "spiking")


def test_spiking_xlstm_stream_is_silent_at_its_threshold():
    """Reference finding: the spiking xLSTM fires the raw residual (no
    norm before the fire) against lif_vth = 1.0, and the seeded
    embeddings (std 0.02) never reach it. Every fire is silent, each
    block returns its zero spikes plus a product of zeros, and the final
    hidden state is all zeros in both packages. At lif_vth = 0.02 the
    first fire spikes and the packages agree."""
    jc, tc = _cfgs("xlstm-350m")
    jp, tp = _trees("xlstm-350m", "f32")
    _, jb, tb = _inputs(jc, "f32", seq=8)
    for v_th in (1.0, 0.02):
        want = jlm.forward_hidden(_vth(jc, v_th), jp, jb["tokens"], True)
        first: list = []
        orig = dispatch.lif_scan

        def fire(x, **kw):
            out = orig(x, **kw)
            first.append(float(out.float().mean()))
            return out
        dispatch.lif_scan = fire
        try:
            with torch.inference_mode():
                got = tlm.forward_hidden(_vth(tc, v_th), tp, tb["tokens"],
                                         True)
        finally:
            dispatch.lif_scan = orig
        assert len(first) == tc.n_layers
        if v_th == 1.0:
            assert not np.any(_f(want)) and not got.any()
            assert first == [0.0] * tc.n_layers
        else:
            assert first[0] > 0 and np.std(_f(want)) > 0.1
            _close(got, want, SSM_F32_TOL)


# --------------------------------------------------------------- resume
@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "xlstm-350m"))
def test_train_loop_resume_equals_the_uninterrupted_run(arch, tmp_path):
    """Reduced qwen2-moe and reduced xlstm-350m, on the kernel path:
    4 steps saving every 2, the newest checkpoint deleted, a resumed run
    from step 2 gives the uninterrupted losses and final params bit for
    bit."""
    import os
    import shutil
    from repro_torch.launch import train as ttrain
    _, tc = _cfgs(arch)
    d = str(tmp_path / "ck")
    kw = dict(steps=4, batch=2, seq=16, ckpt_dir=d, save_every=2,
              log_every=100, device="cpu")
    with dispatch.use_backend("cuda"):
        full = ttrain.train_loop(tc, **kw)
        assert sorted(os.listdir(d)) == ["step_000000002", "step_000000004"]
        shutil.rmtree(os.path.join(d, "step_000000004"))
        resumed = ttrain.train_loop(tc, resume=True, **kw)
    assert len(resumed["losses"]) == 2
    assert resumed["losses"] == full["losses"][2:]
    assert all(np.isfinite(full["losses"]))
    for a, b in zip(adamw.leaves(resumed["params"]),
                    adamw.leaves(full["params"])):
        assert torch.equal(a, b)


def test_train_loop_refuses_a_state_beyond_the_device(monkeypatch):
    """The loop checks the params, gradients and AdamW moments against
    the device's memory before it draws anything: full-depth qwen2-moe
    needs about 172 GB (14.32B parameters: bf16 params and gradients,
    f32 moments), which no one card holds."""
    from repro_torch.configs import registry as treg
    from repro_torch.launch import train as ttrain
    full = treg.get_config("qwen2-moe-a2.7b")
    assert 171e9 < ttrain.train_state_bytes(full) < 173e9
    _, tc = _cfgs("qwen2-moe-a2.7b")
    monkeypatch.setattr(ttrain, "_device_bytes", lambda dev: 10 ** 6)
    with pytest.raises(RuntimeError, match="AdamW moments need .*--reduced.*item 8b"):
        ttrain.train_loop(tc, steps=1, batch=2, seq=16, device="cpu")

