"""The LM from one `LMConfig`: full-sequence prefill and streaming decode,
and the training loss (`loss_fn`, `chunked_ce_loss`), with
`repro.models.lm`'s names, signatures and param-tree layout.

A model is a repeated pattern of blocks scanned over `n_groups`
repetitions with stacked params: ``params["blocks"]`` is a list (one
entry per pattern position) of dicts whose leaves carry a leading
``n_groups`` axis, exactly `repro`'s tree, so `params_from_numpy` carries
a `repro` tree across unchanged. Every decode-state leaf is
``(n_groups, B, ...)``: the slot batch is axis 1, which the slot-state
surgery of the serve loop indexes.

Ported: dense-pattern configs (one attention + MLP block) in both modes.
Spiking (`spiking=True`, the paper's technique): every matmul sees
LIF-fired binary activations, attention is SDSA (O(N) prefill through
the causal prefix-OR, O(d) decode state) and the hidden state is
rate-decoded (mean over the T micro-steps of a leading T axis). Dense
(`spiking=False`, the ANN baseline): softmax GQA with RoPE and a KV
cache, a SwiGLU MLP, no T axis. Not ported yet, and refused with their
ROADMAP item: MoE, hybrid (Mamba), xLSTM and encoder-decoder configs.

Training recomputes as `cfg.remat` says, one group of blocks at a time:
"none" keeps every activation, "full" recomputes the group's forward in
the backward (`torch.utils.checkpoint`), "dots" recomputes all but the
matmul outputs (a selective-checkpoint policy, the port of
`jax.checkpoint_policies.checkpoint_dots`). The three give the same loss
and gradients bit for bit; under "full" every fire and SDSA call of the
forward runs twice a step.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.core.lif import LIFConfig
from . import transformer as tfm
from .layers import (dense_init, embed_init, lif_fire, mlp_apply, mlp_init,
                     rmsnorm, rmsnorm_init)

CONFIG_ITEM = "ROADMAP queue 1 item 5"
MESH_ITEM = "ROADMAP queue 1 item 8"


# ------------------------------------------------------------ pattern plan
class BlockSpec(NamedTuple):
    kind: str          # attn | mamba | mlstm | slstm
    ffn: str           # mlp | moe | none


def layer_pattern(cfg: LMConfig) -> Tuple[List[BlockSpec], int]:
    """(pattern, n_groups) with n_layers == len(pattern) * n_groups. Only
    the dense pattern, one attention + MLP block, is ported."""
    for field, what in (("xlstm", "xLSTM"), ("hybrid", "hybrid (Mamba)"),
                        ("moe", "MoE")):
        if getattr(cfg, field) is not None:
            raise NotImplementedError(
                f"{cfg.name}: {what} blocks are not ported yet "
                f"({CONFIG_ITEM})")
    if cfg.encoder_decoder or cfg.n_frontend_tokens or cfg.encoder_seq:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend configs are not "
            f"ported yet ({CONFIG_ITEM})")
    return [BlockSpec("attn", "mlp")], cfg.n_layers


def lif_cfg_of(cfg: LMConfig) -> LIFConfig:
    return LIFConfig(decay=cfg.spiking.lif_decay, v_th=cfg.spiking.lif_vth)


# ----------------------------------------------------------- tree helpers
def _tree_map(fn, *trees):
    """`fn` over the tensor leaves of matching dict / list / tuple /
    NamedTuple trees; None leaves stay None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _tree_leaves_with_path(tree, path: str = ""):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _tree_leaves_with_path(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def _group(tree, g: int):
    """Group `g`'s slice of a stacked (n_groups, ...) tree (views)."""
    return _tree_map(lambda x: x[g], tree)


def _layer_views(tree, n_groups: int) -> list:
    """The n_groups per-layer slices of a stacked (n_groups, ...) dict
    tree, as views from one `torch.unbind` per leaf: under autograd each
    leaf's gradient is then one stack of the layers' gradients, where
    slicing layer by layer (`_group`) would add a full-size zero-filled
    gradient per layer into the leaf's."""
    if isinstance(tree, dict):
        per = {k: _layer_views(v, n_groups) for k, v in tree.items()}
        return [{k: per[k][g] for k in tree} for g in range(n_groups)]
    return list(torch.unbind(tree, 0))


def _stack(trees: list):
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


# ------------------------------------------------------------------- init
def _block_init(cfg: LMConfig, spec: BlockSpec, generator: torch.Generator,
                device) -> dict:
    return {
        "ln1": rmsnorm_init(cfg.d_model, device),
        "attn": tfm.attn_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.qk_norm,
                              generator=generator, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device),
        "mlp": mlp_init(cfg.d_model, cfg.d_ff, generator=generator,
                        device=device),
    }


def init_params(cfg: LMConfig, seed: int = 0, device="cuda") -> dict:
    """Random params from `seed`, in `repro`'s dtypes (bf16 matrices, f32
    norm scales) and stacked layout. The weights are drawn on `device` by
    a `torch.Generator` that lives there (1.1B values drawn on the CPU
    would take many seconds), so one seed gives the same weights on every
    run on one kind of device, and different ones on the CPU and the card;
    parity with `repro` goes through `params_from_numpy` instead."""
    dev = resolve_device(device)
    pattern, n_groups = layer_pattern(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": embed_init(cfg.vocab, cfg.d_model, generator=gen,
                            device=dev),
        "blocks": [_stack([_block_init(cfg, spec, gen, dev)
                           for _ in range(n_groups)]) for spec in pattern],
        "final_norm": rmsnorm_init(cfg.d_model, dev),
        "lm_head": dense_init(cfg.d_model, cfg.vocab, torch.bfloat16,
                              generator=gen, device=dev),
    }


def param_count(cfg: LMConfig) -> int:
    """Number of parameters, from the shapes alone."""
    _, n_groups = layer_pattern(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    block = (2 * d + d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
             + (2 * hd if cfg.qk_norm else 0))
    return 2 * cfg.vocab * d + d + n_groups * block


# -------------------------------------------------------- full sequence
def _apply_block(cfg: LMConfig, spec: BlockSpec, p: dict, x: torch.Tensor,
                 spiking: bool, *, causal: bool = True) -> torch.Tensor:
    """Full-sequence block. x: (T, B, N, D) spiking / (B, N, D) dense."""
    lif = lif_cfg_of(cfg)
    if spiking:
        s = lif_fire(rmsnorm(p["ln1"], x), lif)
        a = tfm.attention_sdsa(
            p["attn"], s, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            d_head=cfg.head_dim, lif_cfg=lif, mode=cfg.spiking.sdsa_mode,
            causal=causal)
    else:
        a = tfm.attention_dense(
            p["attn"], rmsnorm(p["ln1"], x), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, causal=causal,
            window=cfg.sliding_window, qk_norm=cfg.qk_norm,
            rope_theta=cfg.rope_theta)
    x = x + a
    h = rmsnorm(p["ln2"], x)
    if spiking:
        h = lif_fire(h, lif)
    return x + mlp_apply(p["mlp"], h, spiking=spiking, lif_cfg=lif)


# Matmul outputs: what "dots" keeps and every other remat recomputes.
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: LMConfig, fn):
    """`fn` recomputed in the backward as `cfg.remat` says (see the module
    doc). Where autograd records nothing (serving) it runs as it is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got "
                         f"{cfg.remat!r}")
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)}

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _run_blocks(cfg, blocks, x, spiking, pattern, n_groups, causal):
    layers = [_layer_views(b, n_groups) for b in blocks]

    def group_body(x, group_params):
        for i, spec in enumerate(pattern):
            x = _apply_block(cfg, spec, group_params[i], x, spiking,
                             causal=causal)
        return x

    body = _remat_wrap(cfg, group_body)
    for g in range(n_groups):
        x = body(x, [per[g] for per in layers])
    return x


def _rate_decode(x: torch.Tensor) -> torch.Tensor:
    """Mean over the T micro-steps, accumulated in f32 and returned in
    x's dtype (as `jnp.mean` does on bf16)."""
    return x.float().mean(dim=0).to(x.dtype)


def forward_hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                   spiking: bool, frontend: Optional[torch.Tensor] = None,
                   causal: bool = True) -> torch.Tensor:
    """tokens (B, N) -> final hidden (B, N, D) (T-averaged if spiking)."""
    if frontend is not None:
        raise NotImplementedError(f"frontend embeddings are not ported yet "
                                  f"({CONFIG_ITEM})")
    pattern, n_groups = layer_pattern(cfg)
    x = params["embed"][tokens]                              # (B, N, D)
    if spiking:
        x = x[None].expand((cfg.spiking.t_steps,) + tuple(x.shape))
    x = _run_blocks(cfg, params["blocks"], x, spiking, pattern, n_groups,
                    causal)
    if spiking:
        x = _rate_decode(x)
    return rmsnorm(params["final_norm"], x)


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    return (h @ params["lm_head"].to(h.dtype)).float()


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor, spiking: bool,
            frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence prefill: last-position logits (B, vocab) f32."""
    hidden = forward_hidden(cfg, params, tokens, spiking, frontend=frontend)
    return _logits(params, hidden[:, -1, :])


# ------------------------------------------------------------------- loss
def _ce_chunk(hh: torch.Tensor, w_head: torch.Tensor, ll: torch.Tensor):
    """(sum of lse - target over the chunk's labelled positions, their
    count), both f32; f32 logits from ``hh @ w_head`` in hh's dtype."""
    logits = (hh @ w_head.to(hh.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, ll.clamp_min(0).long()[..., None])[..., 0]
    mask = (ll >= 0).float()
    return ((lse - tgt) * mask).sum(), mask.sum()


def chunked_ce_loss(hidden: torch.Tensor, w_head: torch.Tensor,
                    labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cross-entropy without materializing (N, vocab) logits: a loop over
    sequence chunks, each recomputed in the backward (memory = chunk x
    vocab). Labels below 0 carry no loss. A chunk that does not divide N
    falls back to one chunk of N (tiny shapes)."""
    b, n, d = hidden.shape
    if n % chunk:
        chunk = n
    nc = n // chunk
    h_c = hidden.reshape(b, nc, chunk, d).transpose(0, 1)
    l_c = labels.reshape(b, nc, chunk).transpose(0, 1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        if torch.is_grad_enabled():
            s, c = ckpt.checkpoint(_ce_chunk, h_c[i], w_head, l_c[i],
                                   use_reentrant=False)
        else:
            s, c = _ce_chunk(h_c[i], w_head, l_c[i])
        tot = tot + s
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: LMConfig, params: dict, batch: Dict[str, torch.Tensor],
            spiking: bool) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` {"tokens", "labels"}, both
    (B, N) integers."""
    if cfg.pure_fsdp:
        raise NotImplementedError(
            f"{cfg.name}: pure_fsdp (the per-layer weight gather of a "
            f"sharded mesh) is not ported yet ({MESH_ITEM})")
    if cfg.n_frontend_tokens and "frontend" in batch:
        raise NotImplementedError(
            f"{cfg.name}: frontend positions and their labels are not "
            f"ported yet ({CONFIG_ITEM})")
    hidden = forward_hidden(cfg, params, batch["tokens"], spiking,
                            frontend=batch.get("frontend"))
    return chunked_ce_loss(hidden, params["lm_head"], batch["labels"],
                           cfg.loss_chunk)


# ---------------------------------------------------------------- serving
class LayerState(NamedTuple):
    """Union state for one pattern position (unused fields are None)."""
    kv: Any = None          # tfm.KVCache        (dense attn decode)
    sdsa: Any = None        # tfm.SDSAState      (spiking attn decode)
    mamba: Any = None
    mlstm: Any = None
    slstm: Any = None
    cross_kv: Any = None
    cross_status: Any = None


def init_state(cfg: LMConfig, spec: BlockSpec, b: int, s: int,
               spiking: bool, n_groups: int, device="cuda") -> LayerState:
    """Stacked (n_groups, b, ...) decode state for one pattern position:
    the SDSA statuses when spiking, else a KV cache of capacity `s`."""
    del spec

    def stack(tree):
        return _tree_map(lambda x: x[None].expand(
            (n_groups,) + tuple(x.shape)).contiguous(), tree)
    if spiking:
        return LayerState(sdsa=stack(tfm.sdsa_state_init(
            b, cfg.n_heads, cfg.head_dim, device=device)))
    return LayerState(kv=stack(tfm.kv_cache_init(
        b, s, cfg.n_kv_heads, cfg.head_dim, device=device)))


def init_decode_state(cfg: LMConfig, b: int, s: int, spiking: bool,
                      device="cuda") -> list:
    """Decode-state layout contract (the serve loop relies on it): a list
    of `LayerState`, one per pattern position, and EVERY tensor leaf is
    ``(n_groups, b, ...)`` — the slot batch is axis 1 of every leaf.
    `reset_slot_state` / `merge_slot_state` index that axis structurally."""
    pattern, n_groups = layer_pattern(cfg)
    return [init_state(cfg, spec, b, s, spiking, n_groups, device)
            for spec in pattern]


def _apply_block_decode(cfg, spec, p, st: LayerState, x, pos, spiking):
    del spec
    lif = lif_cfg_of(cfg)
    if spiking:                        # SDSA decode is position-free
        s = lif_fire(rmsnorm(p["ln1"], x), lif)              # (T, B, D)
        a, new_sdsa = tfm.attention_sdsa_decode(
            p["attn"], s, st.sdsa, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            d_head=cfg.head_dim, lif_cfg=lif, mode=cfg.spiking.sdsa_mode)
        st = st._replace(sdsa=new_sdsa)
    else:
        a, new_kv = tfm.attention_dense_decode(
            p["attn"], rmsnorm(p["ln1"], x), st.kv, pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            window=cfg.sliding_window, qk_norm=cfg.qk_norm,
            rope_theta=cfg.rope_theta,
            masked_cache_update=cfg.decode_masked_update)
        st = st._replace(kv=new_kv)
    x = x + a
    h = rmsnorm(p["ln2"], x)
    if spiking:
        h = lif_fire(h, lif)
    return x + mlp_apply(p["mlp"], h, spiking=spiking, lif_cfg=lif), st


def decode_step(cfg: LMConfig, params: dict, state: list,
                token: torch.Tensor, pos, spiking: bool):
    """One serving step. token: (B,) int; pos: a scalar or per-slot (B,)
    positions. Each slot decodes at its own position: in dense mode pos
    is the KV-cache row written, the RoPE angle and the causal mask's
    edge (a scalar broadcasts to every slot); the spiking state is
    position-free.

    Returns (logits (B, vocab) f32, new state): dense mode writes the KV
    caches, spiking mode folds the token's K AND V into each layer's O(d)
    SDSA status."""
    pattern, n_groups = layer_pattern(cfg)
    pos = torch.broadcast_to(torch.as_tensor(pos, device=token.device),
                             token.shape)
    x = params["embed"][token]                               # (B, D)
    if spiking:
        x = x[None].expand((cfg.spiking.t_steps,) + tuple(x.shape))
    per_group: List[List[LayerState]] = [[] for _ in pattern]
    for g in range(n_groups):
        for i, spec in enumerate(pattern):
            x, st = _apply_block_decode(cfg, spec,
                                        _group(params["blocks"][i], g),
                                        _group(state[i], g), x, pos, spiking)
            per_group[i].append(st)
    if spiking:
        x = _rate_decode(x)
    h = rmsnorm(params["final_norm"], x)
    return _logits(params, h), [_stack(sts) for sts in per_group]


def prefill_with_state(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                       spiking: bool, max_seq: Optional[int] = None):
    """Streaming prefill producing the decode state: `decode_step` over the
    prompt. Returns (last-position logits, state ready at pos = N)."""
    b, n = tokens.shape
    state = init_decode_state(cfg, b, max_seq or n, spiking,
                              device=tokens.device)
    logits = None
    for i in range(n):
        logits, state = decode_step(cfg, params, state, tokens[:, i], i,
                                    spiking)
    return logits, state


def prefill_chunked(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                    length, spiking: bool, max_seq: int):
    """Bucketed streaming prefill for continuous-batching admission.

    tokens: (B, L) prompts right-padded to a shared length L; length: (B,)
    true lengths (0 < length <= L). Runs `decode_step` over the L
    positions and masks every state write (and the last-logit capture) to
    steps ``i < length`` per slot, so a pad token leaves the slot's state
    (its KV rows or SDSA status) bitwise unchanged. Returns (last-position
    logits (B, vocab), decode state positioned at ``pos = length`` per
    slot)."""
    b, pad_len = tokens.shape
    state = init_decode_state(cfg, b, max_seq, spiking, device=tokens.device)
    length = torch.as_tensor(length, dtype=torch.int64, device=tokens.device)
    last = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                       device=tokens.device)
    for i in range(pad_len):
        logits, new_state = decode_step(
            cfg, params, state, tokens[:, i],
            torch.full((b,), i, device=tokens.device), spiking)
        live = i < length                                    # (B,)

        def sel(new, old):
            # leaves are (n_groups, B, ...): mask on the slot axis (1)
            return torch.where(live.reshape((1, b) + (1,) * (new.ndim - 2)),
                               new, old)
        state = _tree_map(sel, new_state, state)
        last = torch.where(live[:, None], logits, last)
    return last, state


# ----------------------------------------------- slot-state surgery (serve)
def _check_slot_leaf(path: str, leaf, n_slots: int) -> None:
    if leaf.ndim < 2 or leaf.shape[1] != n_slots:
        raise ValueError(
            f"decode-state leaf at {path} has shape {tuple(leaf.shape)} — "
            f"not slot-batched (expected (n_groups, {n_slots}, ...)). The "
            f"decode-state contract (init_decode_state) puts the slot batch "
            f"at axis 1 of every leaf; refusing to shape-guess.")


def reset_slot_state(state: list, slot: int, n_slots: int) -> list:
    """Zero slot `slot` of every decode-state leaf, by the documented
    layout (every leaf ``(n_groups, n_slots, ...)``): a leaf that breaks
    the contract raises instead of being skipped or zeroed by a
    coincidental dimension. In spiking mode this is O(d) per layer; the
    dense KV cache pays its size."""
    for path, leaf in _tree_leaves_with_path(state):
        _check_slot_leaf(path, leaf, n_slots)

    def zero(x):
        x = x.clone()
        x[:, slot] = 0
        return x
    return _tree_map(zero, state)


def merge_slot_state(pool_state: list, single_state: list, slot) -> list:
    """Scatter a freshly prefilled single-request state (leaves
    ``(n_groups, 1, ...)``) into slot `slot` of the pool state (leaves
    ``(n_groups, n_slots, ...)``). Every leaf of the slot is overwritten,
    so admission never inherits a previous occupant's KV rows or SDSA
    status: merge IS the reset. Returns new tensors (the pool state is not
    written)."""
    def put(pool, one):
        pool = pool.clone()
        pool[:, slot] = one[:, 0].to(pool.dtype)
        return pool
    return _tree_map(put, pool_state, single_state)
