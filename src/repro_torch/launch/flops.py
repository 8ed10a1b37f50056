"""Analytic FLOP / byte model of an LM step, the port of
`repro.launch.flops`: the step's cost from its config alone, in Python
floats, the same arithmetic as the reference's.

A compiled-graph count misses the trip counts of the model's loops (the
groups of blocks, the microbatches, an SSM's steps over time), so the
numerators of a step's FLOP share come from here: exact for the matmuls,
which dominate, and conservative for the elementwise traffic.
`torch.utils.flop_counter.FlopCounterMode` over a step on a loop-free
tiny model agrees with it within the bounds the tests state.

Conventions: 1 MAC = 2 FLOPs. Backward = 2x forward matmul FLOPs;
remat="full" adds 1x forward recompute. Spiking multiplies the block path
by T micro-timesteps (the LM head runs once on the T-averaged hidden).

`step_cost` counts as the reference does, so it undercounts a pattern of
more than one block (jamba's, the xLSTM's) under remat="full": nested
checkpoints run every block but its group's last three times a step, not
twice (`models.lm`'s module doc), about 4.9 forwards a step for an
8-block pattern where it counts 4. `executed_train_flops` adds that
second recompute.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.models.lm import active_param_count, layer_pattern, \
    param_count


@dataclasses.dataclass
class StepCost:
    flops: float               # total FLOPs per step (all devices)
    hbm_bytes: float           # total HBM bytes touched per step
    model_flops_6nd: float     # 6*N_active*D reference
    useful_ratio: float        # model_flops / flops

    def asdict(self):
        return dataclasses.asdict(self)


def _block_fwd_macs_per_token(cfg: LMConfig, spec, n_ctx: int,
                              spiking: bool) -> float:
    """Forward MACs per token for one block of kind `spec`."""
    d, dh = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    macs = 0.0
    if spec.kind == "attn":
        macs += d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d   # q,k,v,o
        if not spiking:
            ctx = min(n_ctx, cfg.sliding_window or n_ctx)
            macs += 2 * ctx * h * dh * 0.5            # causal scores + pv
        # SDSA: elementwise AND/OR only (counted in the elementwise term)
    elif spec.kind == "mamba":
        hy = cfg.hybrid
        di = hy.expand * d
        r = max(16, d // 16)
        macs += d * 2 * di + hy.d_conv * di + di * (r + 2 * hy.d_state) \
            + r * di + 2 * di * hy.d_state + di * d
    elif spec.kind == "mlstm":
        macs += 4 * d * d + 3 * cfg.n_heads * dh * dh
    elif spec.kind == "slstm":
        macs += 4 * d * d + 4 * cfg.n_heads * dh * dh
    if spec.ffn == "mlp":
        macs += 3 * d * cfg.d_ff if cfg.d_ff else 0
        if spec.kind == "slstm":
            macs += 3 * d * ((4 * d) // 3)
    elif spec.ffn == "moe":
        m = cfg.moe
        macs += d * m.n_experts + m.top_k * 3 * d * m.d_ff_expert
        macs += 3 * d * (m.n_shared * m.d_ff_expert)
    return macs


def _elementwise_flops_per_token(cfg: LMConfig, spec) -> float:
    """LIF fire stages + SDSA logic + norms, per token per timestep."""
    d = cfg.d_model
    f = 10 * d                                   # norms/residual/LIF on d
    if spec.kind == "attn":
        f += 5 * cfg.n_heads * cfg.head_dim * 3  # q/k/v LIF + SDSA AND/OR
    if spec.ffn == "mlp":
        f += 5 * cfg.d_ff
    elif spec.ffn == "moe":
        f += 5 * cfg.moe.top_k * cfg.moe.d_ff_expert
    return f


class _EncSpec:
    """The encoder's block: attention with an MLP."""
    kind = "attn"
    ffn = "mlp"


def forward_flops(cfg: LMConfig, n_tokens: float, n_ctx: int,
                  spiking: bool) -> float:
    """Forward FLOPs for n_tokens (decoder stack + head)."""
    pattern, n_groups = layer_pattern(cfg)
    t = cfg.spiking.t_steps if spiking else 1
    per_tok = 0.0
    for spec in pattern:
        per_tok += 2 * _block_fwd_macs_per_token(cfg, spec, n_ctx, spiking)
        per_tok += _elementwise_flops_per_token(cfg, spec)
    per_tok *= n_groups * t
    per_tok += 2 * cfg.d_model * cfg.vocab       # head (post T-average)
    total = per_tok * n_tokens
    if cfg.encoder_decoder:
        enc_tok = cfg.encoder_seq * (n_tokens / max(n_ctx, 1))
        enc_per = (2 * _block_fwd_macs_per_token(
            cfg, _EncSpec, cfg.encoder_seq, spiking)
            + _elementwise_flops_per_token(cfg, _EncSpec)) \
            * cfg.n_encoder_layers * t
        # cross-attention projections in every decoder layer
        cross = 2 * (cfg.d_model * cfg.n_heads * cfg.head_dim * 2) \
            * cfg.n_layers * t * n_tokens
        total += enc_per * enc_tok + cross
    return total


def param_bytes(cfg: LMConfig) -> float:
    return param_count(cfg) * 2.0               # bf16


def _act_bytes(cfg: LMConfig, n_tokens: float, spiking: bool,
               train: bool) -> float:
    """Activation HBM traffic (write+read) estimate."""
    t = cfg.spiking.t_steps if spiking else 1
    d_ff = cfg.d_ff or (cfg.moe.top_k * cfg.moe.d_ff_expert if cfg.moe
                        else 2 * cfg.d_model)
    per_layer_tok = (6 * cfg.d_model + 2 * d_ff) * t
    rw = 2.0                                     # write + read
    passes = 1.0
    if train:
        passes = 2.0 + (1.0 if cfg.remat == "full" else 0.0)
    return per_layer_tok * cfg.n_layers * n_tokens * 2.0 * rw * passes


def step_cost(cfg: LMConfig, shape: ShapeSpec, spiking: bool) -> StepCost:
    b, s = shape.global_batch, shape.seq_len
    n_active = active_param_count(cfg)
    pb = param_bytes(cfg)

    if shape.kind == "train":
        n_tokens = float(b) * s
        fwd = forward_flops(cfg, n_tokens, s, spiking)
        remat_extra = 1.0 if cfg.remat == "full" else 0.0
        flops = fwd * (3.0 + remat_extra)
        # params read (fwd+bwd [+remat]) + grads f32 rw + AdamW states rw
        sdt = 2 if cfg.opt_state_dtype == "bfloat16" else 4
        opt_bytes = param_count(cfg) * (4 * 2 + 2 * sdt * 2 + 2 * 2)
        hbm = pb * (2 + remat_extra) * max(1, cfg.microbatches) + opt_bytes \
            + _act_bytes(cfg, n_tokens, spiking, True)
        model_f = 6.0 * n_active * n_tokens
    elif shape.kind == "prefill":
        n_tokens = float(b) * s
        flops = forward_flops(cfg, n_tokens, s, spiking)
        hbm = pb + _act_bytes(cfg, n_tokens, spiking, False)
        model_f = 2.0 * n_active * n_tokens
    else:   # decode / long_decode: one token per sequence
        n_tokens = float(b)
        flops = forward_flops(cfg, n_tokens, s, spiking)
        hbm = pb + _act_bytes(cfg, n_tokens, spiking, False)
        if not spiking:
            # dense KV cache read: B*S*KV*dh*2(K,V)*2B per attn layer
            pattern, n_groups = layer_pattern(cfg)
            n_attn = sum(1 for sp in pattern if sp.kind == "attn") * n_groups
            hbm += float(b) * s * cfg.n_kv_heads * cfg.head_dim * 2 * 2 \
                * n_attn
        else:
            # O(d) SDSA statuses / SSM states r+w
            hbm += float(b) * cfg.d_model * 4 * 2 * cfg.n_layers
        model_f = 2.0 * n_active * n_tokens
    return StepCost(flops=flops, hbm_bytes=hbm, model_flops_6nd=model_f,
                    useful_ratio=model_f / max(flops, 1.0))


def executed_train_flops(cfg: LMConfig, shape: ShapeSpec,
                         spiking: bool) -> float:
    """A training step's FLOPs as the port runs it: `step_cost`'s plus,
    under remat="full" with a pattern of more than one block, one more
    forward of every block but its group's last (the nested checkpoint's
    second recompute, which `step_cost` leaves out). Like `step_cost` it
    counts each recompute as a whole forward: an upper count, since a
    checkpoint's recompute stops once it has what it saved."""
    flops = step_cost(cfg, shape, spiking).flops
    pattern, n_groups = layer_pattern(cfg)
    if cfg.remat != "full" or len(pattern) < 2:
        return flops
    s = shape.seq_len
    t = cfg.spiking.t_steps if spiking else 1
    per_tok = sum(2 * _block_fwd_macs_per_token(cfg, spec, s, spiking)
                  + _elementwise_flops_per_token(cfg, spec)
                  for spec in pattern[:-1])
    return flops + per_tok * n_groups * t * float(shape.global_batch) * s
