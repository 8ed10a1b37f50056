"""The continuous-batching scheduler in repro_torch (`launch/serve.py`),
on the CPU: the reference's scheduler cases on the port, then the port
against the JAX package's scheduler.

The load-bearing case is staggered-admission parity: a request admitted
into a busy pool (slots at mixed positions) generates the same tokens as
the same prompt served alone, in both modes. Greedy tokens are compared
exactly: they are the surface the scheduler promises. Across packages
both Servers get the same f32 params (`server.params`, carried through
`params_from_numpy`), a clock that ticks on every read (so a trace's
arrivals land while earlier requests are mid-generation), and the same
requests from `benchmarks.serve_traces.make_trace`; the tokens must be
equal.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.serve_traces import bursty_trace, make_trace, poisson_trace
from repro.configs import registry as jreg
from repro.configs.base import LMConfig as JLMConfig
from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.runtime import straggler as jstraggler
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.launch import steps
from repro_torch.launch.serve import (FakeClock, ReplicaLoad, ReplicaPool,
                                      Request, Server)
from repro_torch.models import lm
from repro_torch.models.layers import params_from_numpy
from repro_torch.runtime import faults, straggler

torch.set_num_threads(2)
_CFG_KW = dict(name="sched-test", family="dense", n_layers=2, d_model=32,
               n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat="none",
               loss_chunk=16)
CFG = LMConfig(spiking=SpikingConfig(t_steps=1), **_CFG_KW)
JCFG = JLMConfig(spiking=JSpikingConfig(t_steps=1), **_CFG_KW)
CPU = dict(device="cpu")

# n_heads == n_slots == 4: the dimension collision that fooled the old
# shape-guessing slot reset.
N_SLOTS = 4


def _prompts(n, lens=(5, 9, 7, 4)):
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(0, CFG.vocab, lens[i % len(lens)])))
            for i in range(n)]


def _solo(prompt, max_new, spiking):
    s = Server(CFG, n_slots=1, max_seq=64, spiking=spiking,
               clock=FakeClock(), **CPU)
    r = Request(rid=0, prompt=prompt, max_new=max_new)
    s.submit(r)
    s.run_until_drained()
    assert r.state == "done"
    return r.generated


# ------------------------------------------------- staggered-admission parity
@pytest.mark.parametrize("spiking", [False, True],
                         ids=["dense", "spiking"])
def test_staggered_admission_matches_solo(spiking):
    prompts = _prompts(3)
    solo = [_solo(p, 6, spiking) for p in prompts]
    srv = Server(CFG, n_slots=N_SLOTS, max_seq=64, spiking=spiking,
                 clock=FakeClock(), **CPU)
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    srv.submit(reqs[0])
    srv.step()
    srv.step()                       # req0 is now mid-generation
    srv.submit(reqs[1])              # admitted at a non-aligned position
    srv.step()
    srv.submit(reqs[2])              # and another offset again
    srv.run_until_drained()
    for i, r in enumerate(reqs):
        assert r.state == "done", (i, r.state, r.failure_cause)
        assert r.generated == solo[i], i
    assert all(s is None for s in srv.slot_req)     # no leaked slots


def test_shared_pos_max_is_wrong_vector_pos_is_right():
    """Stepping a staggered pool at the shared ``pos.max()`` diverges from
    solo decode; the per-slot vector matches to 1e-5 (dense mode)."""
    prompt = _prompts(1)[0]
    b1 = len(prompt)
    params = lm.init_params(CFG, seed=0, device="cpu")
    with torch.inference_mode():
        logits_solo, st_solo = lm.prefill_chunked(
            CFG, params, torch.tensor([prompt]), torch.tensor([b1]), False,
            64)
        next_tok = logits_solo.argmax(-1)
        ref_logits, _ = lm.decode_step(CFG, params, st_solo, next_tok, b1,
                                       False)
        pool = lm.init_decode_state(CFG, 2, 64, False, device="cpu")
        pool = lm.merge_slot_state(pool, st_solo, 1)
        pos = torch.tensor([b1 + 5, b1])
        tok = torch.tensor([0, int(next_tok[0])])
        good, _ = lm.decode_step(CFG, params, pool, tok, pos, False)
        bad, _ = lm.decode_step(CFG, params, pool, tok, int(pos.max()),
                                False)
    np.testing.assert_allclose(good[1].numpy(), ref_logits[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(bad[1].numpy(), ref_logits[0].numpy(),
                           rtol=1e-3, atol=1e-3)


def test_chunked_prefill_matches_streaming_prefill():
    params = lm.init_params(CFG, seed=0, device="cpu")
    prompt = _prompts(1)[0]
    toks = torch.tensor([prompt])
    with torch.inference_mode():
        for spiking in (False, True):
            ref_logits, ref_st = lm.prefill_with_state(
                CFG, params, toks, spiking, max_seq=64)
            pad = torch.zeros((1, 16), dtype=torch.long)
            pad[0, :len(prompt)] = toks[0]
            got_logits, got_st = lm.prefill_chunked(
                CFG, params, pad, torch.tensor([len(prompt)]), spiking, 64)
            np.testing.assert_allclose(got_logits.numpy(),
                                       ref_logits.numpy(), rtol=1e-5,
                                       atol=1e-5)
            for a, b in zip(lm._tree_leaves_with_path(got_st),
                            lm._tree_leaves_with_path(ref_st)):
                assert a[0] == b[0]
                np.testing.assert_allclose(a[1].float().numpy(),
                                           b[1].float().numpy(),
                                           rtol=1e-5, atol=1e-5)


def test_quarantine_then_retry_at_non_aligned_position():
    prompts = _prompts(2)
    solo = [_solo(p, 5, True) for p in prompts]
    srv = Server(CFG, n_slots=N_SLOTS, max_seq=64, spiking=True,
                 clock=FakeClock(), backoff_s=0.01, **CPU)
    reqs = [Request(rid=i, prompt=p, max_new=5)
            for i, p in enumerate(prompts)]
    srv.submit(reqs[0])
    srv.step()
    srv.step()
    srv.submit(reqs[1])              # non-aligned admit
    srv.step()
    slot_b = srv.slot_req.index(reqs[1])
    srv.state = faults.nan_decode_state(srv.state, slot=slot_b)
    srv.step()
    srv.run_until_drained()
    assert reqs[1].retries >= 1
    assert reqs[1].failure_cause == "nan_logits"
    assert reqs[1].state == "done"
    assert reqs[1].generated == solo[1]
    assert reqs[0].generated == solo[0] and reqs[0].retries == 0
    assert all(s is None for s in srv.slot_req)


# -------------------------------------------------------- structural reset
@pytest.mark.parametrize("spiking", [False, True], ids=["dense", "spiking"])
def test_reset_slot_state_is_structural_under_dim_collision(spiking):
    state = lm.init_decode_state(CFG, N_SLOTS, 16, spiking, device="cpu")
    poke = lm._tree_map(lambda x: torch.full_like(x, 3.0), state)
    out = lm.reset_slot_state(poke, 1, N_SLOTS)
    leaves = [x for _, x in lm._tree_leaves_with_path(out)]
    assert leaves
    for leaf in leaves:
        assert torch.all(leaf[:, 1] == 0)
        assert torch.all(leaf[:, 0] == 3) and torch.all(leaf[:, 2] == 3)


def test_reset_slot_state_rejects_nonconforming_leaf():
    state = lm.init_decode_state(CFG, N_SLOTS, 16, True, device="cpu")
    bad = [state[0]._replace(sdsa=state[0].sdsa._replace(
        status=torch.zeros((2, N_SLOTS + 1, 4, 8))))] + list(state[1:])
    with pytest.raises(ValueError, match="slot"):
        lm.reset_slot_state(bad, 0, N_SLOTS)


# ------------------------------------------------------------- clock/deadline
def test_fake_clock_drain_never_real_sleeps():
    clk = FakeClock()
    srv = Server(CFG, n_slots=2, max_seq=64, spiking=True, clock=clk,
                 backoff_s=10.0, **CPU)
    req = Request(rid=0, prompt=_prompts(1)[0], max_new=3)
    srv.submit(req)
    srv.step()
    srv.state = faults.nan_decode_state(srv.state, slot=0)
    t0 = time.monotonic()
    srv.run_until_drained()
    assert time.monotonic() - t0 < 30.0     # fake backoff, real seconds
    assert clk() >= 10.0                    # waited in FAKE time
    assert req.state == "done"


def test_trace_arrivals_fire_on_fake_clock():
    clk = FakeClock()
    srv = Server(CFG, n_slots=2, max_seq=64, spiking=True, clock=clk, **CPU)
    reqs = [Request(rid=i, prompt=_prompts(1)[0], max_new=2)
            for i in range(3)]
    srv.submit_at(reqs[0], 0.0)
    srv.submit_at(reqs[2], 50.0)            # far-future arrival
    srv.submit_at(reqs[1], 0.01)            # inserts in arrival order
    assert [r.rid for r in srv.arrivals] == [0, 1, 2]
    fin = srv.run_until_drained()
    assert len(fin) == 3 and all(r.state == "done" for r in reqs)
    assert clk() >= 50.0


def test_deadline_request_that_skipped_submit_fails_loud():
    clk = FakeClock()
    srv = Server(CFG, n_slots=1, max_seq=64, spiking=True, clock=clk, **CPU)
    busy = Request(rid=0, prompt=_prompts(1)[0], max_new=4)
    srv.submit(busy)
    srv.step()
    ghost = Request(rid=1, prompt=_prompts(1)[0], max_new=4,
                    deadline_s=0.5)
    srv.pending.append(ghost)               # bypasses submit()
    srv.step()                              # must not raise
    assert ghost.submitted_at is not None
    clk.advance(1.0)                        # past the ghost's deadline
    srv.run_until_drained()
    assert ghost.state == "failed" and ghost.failure_cause == "deadline"
    assert busy.state == "done"


def test_prompt_too_long_and_raising_prefill_end_with_their_causes():
    """Every exit path records a cause: a prompt past max_seq fails at
    admission, and a prefill that raises quarantines until the retry
    budget is spent (the card's failure mode of a kernel that does not
    launch)."""
    clk = FakeClock()
    srv = Server(CFG, n_slots=2, max_seq=8, spiking=True, clock=clk,
                 backoff_s=0.01, **CPU)
    long = Request(rid=0, prompt=list(range(8)), max_new=2)
    srv.submit(long)

    def broken(*args):
        raise RuntimeError("no kernel")
    srv._prefill = broken
    flaky = Request(rid=1, prompt=[1, 2], max_new=2, max_retries=1)
    srv.submit(flaky)
    srv.run_until_drained()
    assert long.state == "failed" and long.failure_cause == "prompt_too_long"
    assert flaky.state == "failed" and flaky.retries == 1
    assert flaky.failure_cause == "prefill_error:RuntimeError"
    assert all(s is None for s in srv.slot_req)


# ------------------------------------------------------------------- traces
def test_trace_generators_deterministic_and_ordered():
    for name, fn in (("poisson", poisson_trace), ("bursty", bursty_trace)):
        a = fn(seed=3, n_requests=10)
        b = fn(seed=3, n_requests=10)
        assert a == b, name
        ts = [t.arrival_s for t in a]
        assert ts == sorted(ts) and ts[0] == 0.0
        assert fn(seed=4, n_requests=10) != a
    with pytest.raises(ValueError, match="unknown trace"):
        make_trace("sinusoidal")


def test_bursty_trace_replay_terminal_with_causes_no_leaks():
    clk = FakeClock()
    srv = Server(CFG, n_slots=2, max_seq=64, spiking=True, clock=clk, **CPU)
    trace = make_trace("bursty", seed=0, n_requests=8, vocab=CFG.vocab,
                       max_new=(2, 4))
    reqs = []
    for t in trace:
        r = Request(rid=t.rid, prompt=list(t.prompt), max_new=t.max_new)
        srv.submit_at(r, t.arrival_s)
        reqs.append(r)
    fin = srv.run_until_drained()
    assert len(fin) == len(reqs)
    for r in reqs:
        assert r.state in ("done", "failed")
        if r.state == "failed":
            assert r.failure_cause
    assert all(s is None for s in srv.slot_req)
    assert not srv.pending and not srv.arrivals


# ------------------------------------------------------------ replica pool
def test_replica_pool_steers_admission_to_light_replica():
    clk = FakeClock()
    pool = ReplicaPool(CFG, n_replicas=2, clock=clk, n_slots=2, max_seq=64,
                       spiking=True, **CPU)
    for i in range(2):
        pool.replicas[0].submit(
            Request(rid=100 + i, prompt=_prompts(1)[0], max_new=8))
    pool.replicas[0].step()
    r = Request(rid=0, prompt=_prompts(1)[0], max_new=2)
    idx = pool.submit(r)
    assert idx == 1                          # steered away from the load
    assert pool.imbalance_log
    assert pool.imbalance_log[-1].imbalance >= 1.0
    pool.run_until_drained()
    assert all(req.state == "done" for req in pool.finished)


def test_replica_pool_round_robin_baseline_and_bad_balancer():
    clk = FakeClock()
    pool = ReplicaPool(CFG, n_replicas=2, balancer="round_robin",
                       clock=clk, n_slots=2, max_seq=64, spiking=True, **CPU)
    idxs = [pool.submit(Request(rid=i, prompt=_prompts(1)[0], max_new=2))
            for i in range(4)]
    assert idxs == [0, 1, 0, 1]
    pool.run_until_drained()
    with pytest.raises(ValueError, match="balancer"):
        ReplicaPool(CFG, n_replicas=2, balancer="fifo", **CPU)


# ---------------------------------------------------------------- scale smoke
def test_slot_pool_scales_to_many_slots():
    clk = FakeClock()
    srv = Server(CFG, n_slots=64, max_seq=32, spiking=True, clock=clk, **CPU)
    reqs = [Request(rid=i, prompt=[i % CFG.vocab, (i * 7) % CFG.vocab],
                    max_new=2) for i in range(64)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.state == "done" for r in reqs)
    assert all(s is None for s in srv.slot_req)
    assert tuple(srv.state[0].sdsa.status.shape)[:2] == (CFG.n_layers, 64)


# --------------------------------------------------- devices, mesh, faults
def test_server_defaults_to_cuda_and_refuses_a_mesh():
    """The card by default; a mesh is taken (it steers resolution), and a
    value that is not a mesh is refused before any weights are drawn."""
    import inspect
    assert inspect.signature(Server).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Server(CFG)
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        Server(CFG, mesh=object(), **CPU)
    for make in (steps.make_prefill, steps.make_serve_step,
                 steps.make_prefill_state):
        with pytest.raises(TypeError, match="launch.mesh.Mesh"):
            make(CFG, True, mesh=object())
        assert make(CFG, True, mesh=8).__wrapped__ is not None


def test_nan_params_and_nan_decode_state_poison_copies():
    params = lm.init_params(CFG, seed=0, device="cpu")
    bad = faults.nan_params(params, n_leaves=2, seed=1)
    flat = [x for _, x in lm._tree_leaves_with_path(params)]
    poisoned = [x for _, x in lm._tree_leaves_with_path(bad)]
    hit = [i for i, (a, b) in enumerate(zip(flat, poisoned))
           if not torch.equal(a, b)]
    assert len(hit) == 2
    for i in hit:
        assert torch.isnan(poisoned[i].reshape(-1)[0])
        assert not torch.isnan(flat[i]).any()
    state = lm.init_decode_state(CFG, 3, 8, False, device="cpu")
    out = faults.nan_decode_state(state, slot=2)
    for leaf in (x for _, x in lm._tree_leaves_with_path(out)):
        assert torch.isnan(leaf[:, 2]).all()
        assert not torch.isnan(leaf[:, :2]).any()
    assert not any(torch.isnan(x).any()
                   for _, x in lm._tree_leaves_with_path(state))


def test_nan_params_picks_the_reference_leaf():
    """The same seed poisons the same leaf (the reference flattens dicts
    in sorted key order)."""
    from repro.runtime import faults as jfaults
    jp = jlm.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for seed in range(4):
        jb = jax.tree_util.tree_leaves(jfaults.nan_params(jp, 1, seed))
        tb = jax.tree_util.tree_leaves(faults.nan_params(tp, 1, seed))
        assert len(jb) == len(tb)
        assert [bool(np.isnan(np.asarray(a, np.float32)).any()) for a in jb] \
            == [bool(torch.isnan(t.float()).any()) for t in tb]


# ------------------------------------------------------- against repro
class TickClock(FakeClock):
    """A clock that moves `tick` seconds on every read: trace arrivals
    then land between decode steps, while earlier requests run."""

    def __init__(self, tick: float = 0.004):
        super().__init__()
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


@pytest.mark.parametrize("spiking", [False, True], ids=["dense", "spiking"])
def test_server_serves_the_reference_servers_tokens(spiking):
    """The reduced TinyLlama (T = 2: its SDSA statuses fill, which the
    one-step scheduler config's stay empty), 6 bursty requests on 4
    slots."""
    arch = "tinyllama-1.1b"
    tcfg, jcfg = treg.get_reduced(arch), jreg.get_reduced(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jlm.init_params(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    trace = make_trace("bursty", seed=1, n_requests=6, vocab=tcfg.vocab,
                       prompt_len=(3, 11), max_new=(3, 7), burst_size=3,
                       burst_gap_s=0.02)
    servers = (Server(tcfg, n_slots=N_SLOTS, max_seq=32, spiking=spiking,
                      clock=TickClock(), **CPU),
               jserve.Server(jcfg, n_slots=N_SLOTS, max_seq=32,
                             spiking=spiking, clock=TickClock()))
    servers[0].params, servers[1].params = tp, jp
    got = []
    for srv, req_type in zip(servers, (Request, jserve.Request)):
        reqs = [req_type(rid=t.rid, prompt=list(t.prompt), max_new=t.max_new)
                for t in trace]
        for r, t in zip(reqs, trace):
            srv.submit_at(r, t.arrival_s)
        loads = []
        while srv.step() or srv.pending or srv.arrivals:
            loads.append(srv.occupancy_load())
        got.append((reqs, loads))
    (treqs, tloads), (jreqs, jloads) = got
    assert [r.state for r in treqs] == ["done"] * len(trace)
    assert [(r.rid, r.generated) for r in treqs] == \
        [(r.rid, r.generated) for r in jreqs]
    assert servers[0].steps_executed == servers[1].steps_executed
    # admissions overlapped running requests: not one aligned wave
    assert servers[0].steps_executed < sum(t.max_new for t in trace)
    assert [dataclasses.astuple(x) for x in tloads] == \
        [dataclasses.astuple(x) for x in jloads]
    if spiking:
        assert any(x.event_occ > 0 for x in tloads)


@pytest.mark.parametrize("per_shard,routes,pre", [
    ((3, 1, 0, 4), (), None), ((0, 0), ("event", "dense"), None),
    ((5, 5, 2), (), (9, 2, 1)), ((7,), (), None)])
def test_load_signal_matches_the_reference(per_shard, routes, pre):
    a = straggler.occupancy_imbalance(per_shard, routes, pre)
    b = jstraggler.occupancy_imbalance(per_shard, routes, pre)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.as_fields() == b.as_fields()
    with pytest.raises(ValueError, match="no shards"):
        straggler.occupancy_imbalance(())
    for busy, queued, occ in ((0, 0, 0.0), (3, 2, 0.25), (0, 4, 0.5),
                              (8, 0, 0.0371)):
        assert ReplicaLoad(busy, queued, occ).score == \
            jserve.ReplicaLoad(busy, queued, occ).score


@pytest.mark.parametrize("argv", [
    ["--requests", "2", "--max-new", "3"],
    ["--requests", "3", "--max-new", "2", "--dense", "--trace", "bursty",
     "--replicas", "2", "--slots", "2"]], ids=["spiking", "dense-trace-pool"])
def test_cli_serves_on_the_cpu(argv, monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "tinyllama-1.1b",
                                     "--reduced", "--device", "cpu"] + argv)
    serve.main()
    out = capsys.readouterr().out
    assert "kernel backends on cpu" in out
    n = int(argv[1])
    assert f"[serve] {n} requests" in out
    if "--replicas" in argv:
        assert "admission load signal: occ_per_shard=" in out


def test_cli_refuses_cuda_without_a_card_and_a_mesh(monkeypatch, capsys):
    from repro_torch.launch import serve
    base = ["serve", "--arch", "tinyllama-1.1b", "--reduced"]
    if not torch.cuda.is_available():
        monkeypatch.setattr("sys.argv", base)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main()
    monkeypatch.setattr("sys.argv", base + ["--device", "cpu", "--mesh",
                                            "--requests", "1",
                                            "--max-new", "2"])
    serve.main()
    assert "kernel backends (mesh-aware) on cpu" in capsys.readouterr().out


def test_straggler_monitor_matches_the_reference(monkeypatch):
    """The same step times (a clock read twice a step) give the same
    reports: warm-up, EMA, flags, exclusion votes, occupancy riders."""
    times = [1.0, 1.0, 1.1, 1.0, 1.0, 3.5, 3.6, 3.4, 1.0, 5.0, 5.0, 5.0,
             5.0, 5.0, 5.0]
    cfg_kw = dict(threshold=2.0, patience=3, warmup_steps=2)
    reports = []
    for mod in (straggler, jstraggler):
        clock = iter(np.cumsum([0.0] + [x for t in times for x in (t, 0.0)]))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        mon = mod.StragglerMonitor(mod.StragglerConfig(**cfg_kw))
        got = []
        for i, _ in enumerate(times):
            if i % 4 == 1:
                mon.note_occupancy(mod.occupancy_imbalance([i, 1, 2]))
            mon.step_start()
            rep = mon.step_end()
            if "occupancy" in rep:
                rep["occupancy"] = dataclasses.asdict(rep["occupancy"])
            got.append(rep)
        reports.append((got, mon.flagged_steps, mon.consecutive_flags))
    assert reports[0] == reports[1]
    assert reports[0][1] and any(r["exclude_vote"] for r in reports[0][0])


def test_step_factories_call_the_model():
    params = lm.init_params(CFG, seed=0, device="cpu")
    toks = torch.tensor([_prompts(1)[0]])
    with torch.inference_mode():
        for spiking in (False, True):
            assert torch.equal(
                steps.make_prefill(CFG, spiking)(params, {"tokens": toks}),
                lm.prefill(CFG, params, toks, spiking))
            want, _ = lm.prefill_chunked(CFG, params, toks,
                                         torch.tensor([toks.shape[1]]),
                                         spiking, 16)
            got, st = steps.make_prefill_state(CFG, spiking, max_seq=16)(
                params, toks, torch.tensor([toks.shape[1]]))
            assert torch.equal(got, want)
            a, _ = steps.make_serve_step(CFG, spiking)(
                params, st, got.argmax(-1), toks.shape[1])
            b, _ = lm.decode_step(CFG, params, st, got.argmax(-1),
                                  toks.shape[1], spiking)
            assert torch.equal(a, b)
