"""Long-context decode with SDSA: the paper's Attention Core at 500k tokens.

The `long_500k` shape decodes one token against a 524,288-token context.
With softmax attention that means a multi-GB KV cache per sequence; with
the paper's spike-driven attention the whole cross-token state is the
O(d) status vector, so decoding at position 500k costs what it costs at
position 1 — state size independent of context length.

Run: PYTHONPATH=src python -m repro_torch.examples.long_context
     [--ctx 524288] [--tokens 32] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm

CFG = LMConfig(name="long-demo", family="dense", n_layers=4, d_model=256,
               n_heads=8, n_kv_heads=4, d_ff=512, vocab=4096,
               spiking=SpikingConfig(t_steps=2), remat="none",
               loss_chunk=32)

CTX = 524_288


def state_bytes(state) -> int:
    """Bytes of every tensor in a decode state."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(x) for x in state)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=CTX)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ctx = args.ctx
    params = lm.init_params(CFG, seed=0, device=dev)

    # SDSA state: O(d) per layer, independent of the 500k context.
    state = lm.init_decode_state(CFG, b=1, s=ctx, spiking=True, device=dev)
    sz = state_bytes(state)
    print(f"SDSA decode state @ {ctx:,} ctx: {sz/1e3:.1f} KB")
    kv = lm.init_decode_state(CFG, b=1, s=ctx, spiking=False, device=dev)
    kv_sz = state_bytes(kv)
    print(f"dense KV cache   @ {ctx:,} ctx: {kv_sz/1e6:,.0f} MB "
          f"({kv_sz/sz:,.0f}x larger)")
    del kv

    step = steps_mod.make_serve_step(CFG, spiking=True)
    tok = torch.tensor([1], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        # warm the state with a few "recent" tokens, then decode at ~500k
        for i in range(4):
            logits, state = step(params, state, tok, ctx - 8 + i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        n = args.tokens
        generated = []
        for i in range(n):
            logits, state = step(params, state, tok, ctx - 4 + i % 4)
            tok = logits.argmax(dim=-1).to(torch.int32)
            generated.append(int(tok[0]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.time() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"decoded {n} tokens at ~{ctx:,}-token positions: "
          f"{n/dt:.1f} tok/s on {where} — per-token cost is context-free "
          f"(the OR-status update of Sec. III-C)")
    return dict(state_bytes=sz, kv_bytes=kv_sz, tokens=generated,
                finite=bool(torch.isfinite(logits).all()))


if __name__ == "__main__":
    main()
