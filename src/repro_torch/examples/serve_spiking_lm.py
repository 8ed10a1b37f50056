"""Batched serving demo: continuous-batching decode over slot state.

Compares the two serving modes:
  * spiking (SDSA) — O(d) per-slot state, constant-memory long contexts;
  * dense baseline — real KV cache, the decode_32k regime.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_spiking_lm
     [--requests 10] [--max-new 24] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.examples.quickstart import state_elems
from repro_torch.launch.serve import Request, Server

CFG = LMConfig(name="serve-demo", family="dense", n_layers=4, d_model=256,
               n_heads=8, n_kv_heads=4, d_ff=512, vocab=4096,
               spiking=SpikingConfig(t_steps=2), remat="none",
               loss_chunk=32)


def drive(spiking: bool, label: str, n_requests: int = 10,
          max_new: int = 24, device="cuda"):
    server = Server(CFG, n_slots=4, max_seq=128, spiking=spiking,
                    device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(t) for t in
                                   rng.integers(0, CFG.vocab, 12)],
                    max_new=max_new) for i in range(n_requests)]
    t0 = time.time()
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in reqs)
    print(f"[{label}] {len(reqs)} reqs x {max_new} new tokens: {toks} "
          f"tokens in {dt:.1f}s ({toks/dt:.1f} tok/s), decode state "
          f"{state_elems(server.state)/1e6:.2f}M elems")
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    a = drive(True, "spiking SDSA (O(d) state)", args.requests,
              args.max_new, args.device)
    b = drive(False, "dense GQA  (KV cache)  ", args.requests,
              args.max_new, args.device)
    print("sample generations (spiking):",
          [r.generated[:6] for r in a[:2]])
    return dict(spiking=[r.generated for r in a],
                dense=[r.generated for r in b],
                states=[r.state for r in a + b])


if __name__ == "__main__":
    main()
