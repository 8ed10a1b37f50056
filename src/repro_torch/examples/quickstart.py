"""Quickstart: the ExSpike stack in a few steps.

  1. build a spiking LM (LIF + SDSA, binary activations everywhere),
  2. run one forward/backward step,
  3. inspect event sparsity + APEC compression on a real spike tensor,
  4. compare SDSA's O(d) decode state against a dense KV cache.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig, SpikingConfig
from repro_torch.core import apec
from repro_torch.core.lif import LIFConfig
from repro_torch.models import lm
from repro_torch.models.layers import lif_fire
from repro_torch.optim import adamw

CFG = LMConfig(name="quickstart", family="dense", n_layers=4, d_model=128,
               n_heads=8, n_kv_heads=4, d_ff=256, vocab=512,
               spiking=SpikingConfig(t_steps=2), remat="none", loss_chunk=32)


def state_elems(state) -> int:
    """Elements of every tensor in a decode state."""
    if isinstance(state, torch.Tensor):
        return state.numel()
    if isinstance(state, (list, tuple)):
        return sum(state_elems(x) for x in state)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CFG

    params = lm.init_params(cfg, seed=0, device=dev)
    leaves = adamw.leaves(params)
    n_params = sum(p.numel() for p in leaves)
    print(f"model: {cfg.name}, {n_params/1e6:.2f}M params, "
          f"T={cfg.spiking.t_steps}")

    # --- 1. spiking forward + loss + grads -------------------------------
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen).to(dev)
    batch = {"tokens": tokens, "labels": tokens}
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.loss_fn(cfg, params, batch, spiking=True)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    loss = loss.detach()
    gnorm = sum(float((g.float() ** 2).sum()) for g in grads) ** 0.5
    print(f"spiking loss {float(loss):.4f}  grad norm {gnorm:.3f}")

    # --- 2. event statistics on a real spike tensor ----------------------
    with torch.no_grad():
        drive = torch.randn((2, 4, 64, 128),
                            generator=torch.Generator().manual_seed(2)).to(dev)
        spikes = lif_fire(drive, LIFConfig())
        sparsity = 1.0 - float(spikes.float().mean())
        binary = bool(((spikes == 0) | (spikes == 1)).all())
        print(f"LIF spikes: binary={binary}, sparsity={sparsity:.2%}")

        # --- 3. APEC: compress adjacent-position events (Eq. 1-3) --------
        flat = spikes.reshape(-1, 128)
        st = apec.apec_stats(flat, g=2)
        print(f"APEC-2: events {float(st.events_before):.0f} -> "
              f"{float(st.events_after):.0f} "
              f"({float(st.reduction_ratio):.2f}x reduction, exact by "
              f"linearity)")
        w = torch.randn((128, 64),
                        generator=torch.Generator().manual_seed(3)).to(dev)
        err = (apec.apec_matmul(flat, w, 2) - flat @ w).abs().max()
        print(f"APEC matmul max error vs dense: {float(err):.2e}")

    # --- 4. O(d) SDSA decode state vs dense KV cache ---------------------
    sdsa_state = lm.init_decode_state(cfg, b=1, s=32768, spiking=True,
                                      device=dev)
    kv_state = lm.init_decode_state(cfg, b=1, s=32768, spiking=False,
                                    device=dev)
    a, b = state_elems(sdsa_state), state_elems(kv_state)
    print(f"decode state @32k ctx: SDSA={a/1e3:.1f}K elems, "
          f"dense KV cache={b/1e6:.1f}M elems ({b/a:.0f}x larger)")
    return dict(loss=float(loss), grad_norm=gnorm, sparsity=sparsity,
                apec_err=float(err), sdsa_elems=a, kv_elems=b)


if __name__ == "__main__":
    main()
