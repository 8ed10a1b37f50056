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

Ported: every config of the registry in both modes. The attention
family: patterns of attention blocks with an MLP or MoE FFN (`moe_every`
/ `moe_offset` place the MoE layers), qk-norm and sliding windows, the
encoder-decoder (whisper: a non-causal encoder over stub frame
embeddings, per-layer cross-attention to its output) and the VLM's stub
patch embeddings prepended to the decoder stream. The SSM families
(`models/ssm.py`): jamba's hybrid, Mamba blocks with one attention block
a period, and xLSTM's mLSTM blocks with one sLSTM a period and no FFN.
Spiking (`spiking=True`, the paper's technique): every matmul sees
LIF-fired binary activations, attention is SDSA (O(N) prefill through
the causal prefix-OR, the encoder's non-causal OR over all tokens, O(d)
decode state), the SSM recurrences carry their O(d * d_state) state, and
the hidden state is rate-decoded (mean over the T micro-steps of a
leading T axis). Dense (`spiking=False`, the ANN baseline): softmax GQA
with RoPE and a KV cache, a SwiGLU MLP, no T axis.

Three reference findings the port keeps, as the reference computes them:
  * spiking xLSTM fires the raw residual, with no norm before the fire,
    against `lif_vth = 1.0`; the seeded embeddings (std 0.018) never
    reach it, so every block returns its zero spikes plus a product of
    zeros and the hidden state is all zeros (a lower `lif_vth`, such as
    0.02, fires);
  * an sLSTM block draws an `ln2` and a 4d/3-wide `mlp` that its "none"
    FFN never applies (12,582,912 of xlstm-350m's 222,763,264
    parameters);
  * spiking mLSTM and sLSTM blocks replace the residual stream with
    their output, the fired spikes plus the block's product
    (`mlstm_apply` / `slstm_apply` add their own input).

As in the reference, decoding never fills an encoder-decoder's cross
state: `init_state` makes the cross-attention K / V (dense) or status
(spiking) zeros and `decode_step` reads them as they are.

Training recomputes as `cfg.remat` says, one group of blocks at a time:
"none" keeps every activation, "full" recomputes the group's forward in
the backward (`torch.utils.checkpoint`), "dots" recomputes all but the
matmul outputs (a selective-checkpoint policy, the port of
`jax.checkpoint_policies.checkpoint_dots`). Under "full" a pattern of
more than one block also checkpoints each block inside its group's
checkpoint, as the reference nests them, so the backward holds one
block's internals at a time. The three give the same loss and gradients
bit for bit; under "full" every fire and SDSA call of the forward runs
twice a step in a one-block pattern; in a nested one three times, and
twice in a group's last block (its group's recompute stops at its
input).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.core.lif import LIFConfig
from . import moe as moe_lib
from . import placement
from . import ssm
from . import transformer as tfm
from .layers import (dense_init, embed_init, lif_fire, mlp_init, rmsnorm,
                     rmsnorm_init)


# ------------------------------------------------------------ pattern plan
class BlockSpec(NamedTuple):
    kind: str          # attn | mamba | mlstm | slstm
    ffn: str           # mlp | moe | none


def layer_pattern(cfg: LMConfig) -> Tuple[List[BlockSpec], int]:
    """(pattern, n_groups) with n_layers == len(pattern) * n_groups.

    xLSTM: `xlstm.period` blocks, the one at `slstm_index` an sLSTM and
    the rest mLSTM, none with an FFN. Hybrid (jamba): `hybrid.period`
    blocks, the one at `attn_index` attention and the rest Mamba. Else
    one attention block per layer, the pattern `moe_every` layers long.
    Outside xLSTM a layer's FFN is an MoE where ``layer % moe.moe_every
    == moe.moe_offset`` and an MLP elsewhere."""
    if cfg.xlstm is not None:
        period = cfg.xlstm.period
        pat = [BlockSpec("slstm" if i == cfg.xlstm.slstm_index else "mlstm",
                         "none") for i in range(period)]
    else:
        def ffn_kind(layer_idx: int) -> str:
            if cfg.moe is None:
                return "mlp"
            return "moe" if layer_idx % cfg.moe.moe_every == \
                cfg.moe.moe_offset else "mlp"

        if cfg.hybrid is not None:
            period = cfg.hybrid.period
            pat = [BlockSpec("attn" if i == cfg.hybrid.attn_index
                             else "mamba", ffn_kind(i))
                   for i in range(period)]
        else:
            period = cfg.moe.moe_every if cfg.moe is not None else 1
            pat = [BlockSpec("attn", ffn_kind(i)) for i in range(period)]
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"multiple of the pattern's {period}")
    return pat, cfg.n_layers // period


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
                device, cross: bool) -> dict:
    """One layer's params, `repro`'s tree: `ln1` before attention and
    Mamba only (mLSTM and sLSTM norm their input themselves); an sLSTM
    block also carries the reference's `ln2` and a 4d/3-wide `mlp` that
    its "none" FFN never applies (a reference finding, kept so the trees
    and parameter counts match)."""
    kw = dict(generator=generator, device=device)
    p = {}
    if spec.kind == "attn":
        p["ln1"] = rmsnorm_init(cfg.d_model, device)
        p["attn"] = tfm.attn_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, cfg.qk_norm, **kw)
    elif spec.kind == "mamba":
        hy = cfg.hybrid
        p["ln1"] = rmsnorm_init(cfg.d_model, device)
        p["mamba"] = ssm.mamba_init(cfg.d_model, hy.d_state, hy.d_conv,
                                    hy.expand, **kw)
    elif spec.kind == "mlstm":
        p["mlstm"] = ssm.mlstm_init(cfg.d_model, cfg.n_heads, **kw)
    elif spec.kind == "slstm":
        p["slstm"] = ssm.slstm_init(cfg.d_model, cfg.n_heads, **kw)
        p["ln2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = mlp_init(cfg.d_model, (4 * cfg.d_model) // 3, **kw)
    if cross and spec.kind == "attn":
        p["cross_ln"] = rmsnorm_init(cfg.d_model, device)
        p["cross_attn"] = tfm.attn_init(cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.head_dim, False,
                                        **kw)
    if spec.ffn == "mlp":
        p["ln2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, **kw)
    elif spec.ffn == "moe":
        m = cfg.moe
        p["ln2"] = rmsnorm_init(cfg.d_model, device)
        p["moe"] = moe_lib.moe_init(cfg.d_model, m.d_ff_expert, m.n_experts,
                                    m.n_shared, bank_size=m.bank_size, **kw)
    return p


def _stack_init(cfg: LMConfig, pattern: List[BlockSpec], n_groups: int,
                generator: torch.Generator, device, cross: bool,
                cut=None, prefix: Tuple[str, ...] = ("blocks",)) -> list:
    """Per pattern position, its n_groups layers' params stacked on a
    leading axis. Each layer is drawn, copied into its slice and freed,
    so the peak is the stack plus one layer (an MoE's expert banks are
    most of a model); with `cut` (see `init_params`) the stack holds each
    layer's kept part."""
    out = []
    for i, spec in enumerate(pattern):
        stacked = None
        for g in range(n_groups):
            layer = _block_init(cfg, spec, generator, device, cross)
            if cut is not None:
                layer = cut(prefix + (str(i),), layer, True)
            if stacked is None:
                stacked = _tree_map(lambda x: x.new_empty(
                    (n_groups,) + tuple(x.shape)), layer)
            _tree_map(lambda dst, src: dst[g].copy_(src), stacked, layer)
            del layer
        out.append(stacked)
    return out


def init_params(cfg: LMConfig, seed: int = 0, device="cuda",
                cut=None) -> dict:
    """Random params from `seed`, in `repro`'s dtypes (bf16 matrices, f32
    norm scales and router) and stacked layout. The weights are drawn on
    `device` by a `torch.Generator` that lives there (a billion values
    drawn on the CPU would take many seconds), so one seed gives the same
    weights on every run on one kind of device, and different ones on
    the CPU and the card; parity with `repro` goes through
    `params_from_numpy` instead. On the `meta` device nothing is drawn:
    the tree's shapes and dtypes only.

    `cut(prefix, tree, layer)` keeps a part of each subtree as it is
    drawn (`prefix` its path, `layer` whether it is one layer of a
    stacked block, without the group axis): the same values, and a peak
    of the kept tree plus one layer (`runtime.sharding.local_init`, a
    rank's `local_params` of the seed's tree)."""
    dev = resolve_device(device)
    pattern, n_groups = layer_pattern(cfg)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev) \
        .manual_seed(seed)

    def kept(prefix, tree):
        return tree if cut is None else cut(prefix, tree, False)
    p = {
        "embed": kept(("embed",), embed_init(
            cfg.vocab, cfg.d_model, generator=gen, device=dev)),
        "blocks": _stack_init(cfg, pattern, n_groups, gen, dev,
                              cross=cfg.encoder_decoder, cut=cut),
        "final_norm": kept(("final_norm",), rmsnorm_init(cfg.d_model, dev)),
        "lm_head": kept(("lm_head",), dense_init(
            cfg.d_model, cfg.vocab, torch.bfloat16, generator=gen,
            device=dev)),
    }
    if cfg.encoder_decoder:
        p["encoder"] = {
            "blocks": _stack_init(cfg, [BlockSpec("attn", "mlp")],
                                  cfg.n_encoder_layers, gen, dev,
                                  cross=False, cut=cut,
                                  prefix=("encoder", "blocks")),
            "final_norm": kept(("encoder", "final_norm"),
                               rmsnorm_init(cfg.d_model, dev))}
    if cfg.n_frontend_tokens or cfg.encoder_seq:
        # The stub frontend's projection of precomputed embeddings.
        p["frontend_proj"] = kept(("frontend_proj",), dense_init(
            cfg.d_model, cfg.d_model, torch.bfloat16, generator=gen,
            device=dev))
    return p


def abstract_params(cfg: LMConfig) -> dict:
    """The param tree on the `meta` device: shapes and dtypes, no memory
    (the spec rules' stand-in, as `repro`'s ShapeDtypeStruct tree)."""
    return init_params(cfg, device="meta")


def param_count(cfg: LMConfig) -> int:
    """Number of parameters: the leaves of `abstract_params` (shapes only,
    nothing drawn)."""
    return sum(leaf.numel() for _, leaf in
               _tree_leaves_with_path(abstract_params(cfg)))


def active_param_count(cfg: LMConfig) -> int:
    """Parameters a token uses, the reference's count: every leaf, with
    the `w_gate` / `w_up` / `w_down` leaves under `moe` counted at
    top_k / n_experts (its shared experts' among them, as the reference
    counts them)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    experts = 0
    for path, leaf in _tree_leaves_with_path(abstract_params(cfg)):
        keys = path.replace("]", "").split("[")
        if "'moe'" in keys and keys[-1] in ("'w_gate'", "'w_up'",
                                            "'w_down'"):
            experts += leaf.numel()
    active_frac = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - experts * (1 - active_frac))


# -------------------------------------------------------- full sequence
def _ffn(cfg: LMConfig, spec: BlockSpec, p: dict, x: torch.Tensor,
         spiking: bool, decode: bool = False) -> torch.Tensor:
    """x plus the block's FFN (MLP or MoE) on its ln2-normed (and, when
    spiking, fired) input. In decode the MoE routes the step's T x B
    tokens together, as one sequence position each."""
    lif = lif_cfg_of(cfg)
    pl = placement.of(cfg)
    h = rmsnorm(p["ln2"], x)
    if spiking:
        h = lif_fire(h, lif)
    if spec.ffn == "mlp":
        return x + placement.mlp(pl, p["mlp"], h, cfg.d_ff, spiking=spiking,
                                 lif_cfg=lif)
    m = cfg.moe
    kw = dict(top_k=m.top_k, capacity_factor=m.capacity_factor,
              spiking=spiking, lif_cfg=lif)
    if decode:
        h = h[..., None, :]
    if pl.tp and m.n_shared:
        # the shared experts' MLP over the model positions
        kw["shared_mlp"] = functools.partial(
            placement.mlp, pl, width=m.n_shared * m.d_ff_expert,
            spiking=spiking, lif_cfg=lif)
    # On a rank mesh both forms route the global batch, each rank's rows
    # gathered in the reference's token order (`moe_lib.moe_apply`).
    if cfg.moe_shard_map:
        # the ambient mesh, as the reference reads `current_mesh()`
        from repro_torch.launch.mesh import current_mesh
        out = moe_lib.moe_apply_shard_map(p["moe"], h, mesh=current_mesh(),
                                          placed=pl, **kw)
    else:
        # the reference's decode routes one group, whatever the config
        groups = 1 if decode else cfg.moe_dispatch_groups
        out = moe_lib.moe_apply(p["moe"], h, dispatch_groups=groups,
                                placed=pl, **kw)
    return x + (out[..., 0, :] if decode else out)


def _apply_block(cfg: LMConfig, spec: BlockSpec, p: dict, x: torch.Tensor,
                 spiking: bool, *, causal: bool = True,
                 enc_kv: Optional[tuple] = None) -> torch.Tensor:
    """Full-sequence block. x: (T, B, N, D) spiking / (B, N, D) dense;
    `enc_kv` this layer's cross-attention K / V of the encoder output.

    Spiking SSM blocks run their recurrence once per micro-step on the
    fired input (the reference's `jax.vmap` over T). Mamba adds its output
    to the residual; mLSTM and sLSTM fire the raw residual (no norm
    before the fire) and their output, the spikes plus the block's
    product, replaces the stream (`mlstm_apply` / `slstm_apply` add their
    own input): both as the reference does."""
    lif = lif_cfg_of(cfg)
    if spec.kind == "attn":
        if spiking:
            s = lif_fire(rmsnorm(p["ln1"], x), lif)
            a = _attention(cfg, p["attn"], s, lambda pp, xx, h, kv:
                           tfm.attention_sdsa(
                               pp, xx, n_heads=h, n_kv=kv,
                               d_head=cfg.head_dim, lif_cfg=lif,
                               mode=cfg.spiking.sdsa_mode, causal=causal))
        else:
            a = _attention(cfg, p["attn"], rmsnorm(p["ln1"], x),
                           lambda pp, xx, h, kv: tfm.attention_dense(
                               pp, xx, n_heads=h, n_kv=kv,
                               d_head=cfg.head_dim, causal=causal,
                               window=cfg.sliding_window,
                               qk_norm=cfg.qk_norm,
                               rope_theta=cfg.rope_theta))
        x = x + a
        if enc_kv is not None and "cross_attn" in p:
            x = x + _cross_attn_full(cfg, p, x, enc_kv, spiking)
    elif spec.kind == "mamba":
        hy = cfg.hybrid
        h = rmsnorm(p["ln1"], x)
        if spiking:
            s = lif_fire(h, lif)
            out = torch.stack([ssm.mamba_apply(p["mamba"], st, None,
                                               hy.d_state, hy.d_conv)[0]
                               for st in s])
        else:
            out, _ = ssm.mamba_apply(p["mamba"], h, None, hy.d_state,
                                     hy.d_conv)
        x = x + out
    else:
        apply = getattr(ssm, f"{spec.kind}_apply")
        if spiking:
            s = lif_fire(x, lif)
            x = torch.stack([apply(p[spec.kind], st, cfg.n_heads)[0]
                             for st in s])
        else:
            x, _ = apply(p[spec.kind], x, cfg.n_heads)
    if spec.ffn == "none":
        return x
    return _ffn(cfg, spec, p, x, spiking)


def _attention(cfg: LMConfig, p: dict, x: torch.Tensor, fn, state=None):
    """``fn(p, x, n_heads, n_kv[, state])``, an attention block's output
    (and new decode state), over the model positions where the query and
    KV heads both split evenly: each runs its own heads
    (`placement.row_parallel`); elsewhere every head at once."""
    pl = placement.of(cfg)
    if not pl.heads():
        if state is None:
            return fn(p, x, cfg.n_heads, cfg.n_kv_heads)
        return fn(p, x, cfg.n_heads, cfg.n_kv_heads, state)
    h, kv = cfg.n_heads // pl.m, cfg.n_kv_heads // pl.m
    if state is None:
        return placement.row_parallel(pl, lambda xx, pp: fn(pp, xx, h, kv),
                                      x, p, placement.ATTN_CUTS)
    return placement.row_parallel(
        pl, lambda xx, pp, st: fn(pp, xx, h, kv, st), x, p,
        placement.ATTN_CUTS, state=state)


def _cross_attn_full(cfg: LMConfig, p: dict, x: torch.Tensor, enc_kv,
                     spiking: bool) -> torch.Tensor:
    """Cross-attention to the encoder's projected keys and values
    (B, S, KV, dh). Spiking: the status is the OR over encoder positions
    of K AND V (an amax), and the output Q AND status, for every decoder
    position; dense: softmax attention over the S positions."""
    k_enc, v_enc = enc_kv
    pa = p["cross_attn"]
    h = rmsnorm(p["cross_ln"], x)
    rep = cfg.n_heads // cfg.n_kv_heads
    if spiking:
        lif = lif_cfg_of(cfg)
        q = lif_fire(h, lif)
        qh = (q @ pa["w_q"].to(q.dtype)).reshape(
            tuple(q.shape[:-1]) + (cfg.n_heads, cfg.head_dim))
        qh = lif_fire(qh, lif)
        status = tfm._repeat_kv((k_enc * v_enc).amax(dim=-3), rep)  # B,H,dh
        out = qh * status[None, :, None]
        out = out.reshape(tuple(q.shape[:-1]) + (-1,))
        return out @ pa["w_o"].to(out.dtype)
    qh = (h @ pa["w_q"].to(h.dtype)).reshape(
        tuple(h.shape[:-1]) + (cfg.n_heads, cfg.head_dim))
    kk = tfm._repeat_kv(k_enc, rep).transpose(-3, -2)     # (B, H, S, dh)
    vv = tfm._repeat_kv(v_enc, rep).transpose(-3, -2)
    qq, kk = tfm._promoted(qh.transpose(-3, -2), kk)
    sc = (qq @ kk.transpose(-1, -2)).float()
    pr = torch.softmax(sc * cfg.head_dim ** -0.5, dim=-1).to(h.dtype)
    pr, vv = tfm._promoted(pr, vv)
    out = (pr @ vv).transpose(-3, -2)
    out = out.reshape(tuple(h.shape[:-1]) + (cfg.n_heads * cfg.head_dim,))
    return out @ pa["w_o"].to(out.dtype)


# Matmul outputs: what "dots" keeps and every other remat recomputes.
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: LMConfig, fn, gathers: bool = False):
    """`fn` recomputed in the backward as `cfg.remat` says (see the module
    doc); `gathers` (a group that gathers placed weights) recomputes it
    whole whatever `cfg.remat` says, so its gathered weights are not
    kept for the backward. Where autograd records nothing (serving) it
    runs as it is."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got "
                         f"{cfg.remat!r}")
    mode = "full" if gathers else cfg.remat
    if mode == "none":
        return fn
    kw = {} if mode == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)}

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _run_blocks(cfg, blocks, x, spiking, pattern, n_groups, causal,
                enc_kv=None, prefix: Tuple[str, ...] = ("blocks",)):
    """The groups of blocks in order; with `enc_kv` (the encoder's output)
    each attention block with a cross-attention first projects it to its
    own K / V. `prefix`: the blocks' path in the param tree (their specs'
    on a rank mesh)."""
    layers = [_layer_views(b, n_groups) for b in blocks]
    pl = placement.of(cfg)

    # Under "full" a heterogeneous pattern (jamba's and the xLSTM's
    # 8-block periods) also checkpoints each block inside the group's
    # checkpoint, as the reference nests a second `jax.checkpoint`: the
    # backward then holds one block's internals (an SSM block's per-step
    # tensors) at a time instead of the whole group's.
    nested = cfg.remat == "full" and len(pattern) > 1

    def sub_block(spec):
        def f(x, p):
            kv = None
            if enc_kv is not None:
                kv = _project_enc_kv(cfg, p, enc_kv, spiking)
            return _apply_block(cfg, spec, p, x, spiking, causal=causal,
                                enc_kv=kv)
        return _remat_wrap(cfg, f) if nested else f

    subs = [sub_block(spec) for spec in pattern]

    # On a rank mesh each group gathers its placed weights here, inside
    # the group's recompute, as the reference's `_unshard_weights` does
    # under `pure_fsdp` (`placement.Placement.gathered`). A recompute runs
    # under the forward's mesh, whatever is ambient in the backward.
    in_scope = placement.scope()

    def group_body(x, group_params):
        def run(x):
            for i, (f, p) in enumerate(zip(subs, group_params)):
                x = f(x, pl.gathered(p, prefix + (str(i),), layer=True))
            return x
        return in_scope(run, x)

    body = _remat_wrap(cfg, group_body, gathers=pl.gathers(prefix))
    for g in range(n_groups):
        x = body(x, [per[g] for per in layers])
    return x


def _rate_decode(x: torch.Tensor) -> torch.Tensor:
    """Mean over the T micro-steps, accumulated in f32 and returned in
    x's dtype (as `jnp.mean` does on bf16)."""
    return x.float().mean(dim=0).to(x.dtype)


def _project_enc_kv(cfg: LMConfig, p: dict, enc_hidden: torch.Tensor,
                    spiking: bool):
    """This layer's cross K / V (B, S, KV, dh) of the encoder output
    (B, S, D), fired at T = 1 when spiking; None without a
    cross-attention."""
    if "cross_attn" not in p:
        return None
    pa, h = p["cross_attn"], enc_hidden
    lead = tuple(h.shape[:-1]) + (cfg.n_kv_heads, cfg.head_dim)
    k = (h @ pa["w_k"].to(h.dtype)).reshape(lead)
    v = (h @ pa["w_v"].to(h.dtype)).reshape(lead)
    if spiking:
        lif = lif_cfg_of(cfg)
        k = lif_fire(k[None], lif)[0]
        v = lif_fire(v[None], lif)[0]
    return k, v


def _encoder_forward(cfg: LMConfig, params: dict,
                     frontend: Optional[torch.Tensor],
                     spiking: bool) -> torch.Tensor:
    """The whisper-style encoder over stub frame embeddings (B, S, D):
    non-causal attention blocks with MLPs, rate-decoded when spiking,
    then its final norm."""
    if frontend is None:
        raise ValueError("an encoder-decoder arch needs frontend "
                         "embeddings")
    enc = params["encoder"]
    pl = placement.of(cfg)
    proj = pl.gathered(params["frontend_proj"], ("frontend_proj",))
    x = frontend @ proj.to(frontend.dtype)
    if spiking:
        x = x[None].expand((cfg.spiking.t_steps,) + tuple(x.shape))
    x = _run_blocks(cfg, enc["blocks"], x, spiking,
                    [BlockSpec("attn", "mlp")], cfg.n_encoder_layers,
                    causal=False, prefix=("encoder", "blocks"))
    if spiking:
        x = _rate_decode(x)
    return rmsnorm(pl.gathered(enc["final_norm"],
                               ("encoder", "final_norm")), x)


def forward_hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                   spiking: bool, frontend: Optional[torch.Tensor] = None,
                   causal: bool = True) -> torch.Tensor:
    """tokens (B, N) -> final hidden (B, N, D) (T-averaged if spiking).

    `frontend` (B, F, D), precomputed stub embeddings: a decoder-only
    config (the VLM) projects and prepends them to the token stream, so
    the hidden state is (B, F + N, D); an encoder-decoder runs its
    encoder on them and every decoder layer cross-attends to its output."""
    pattern, n_groups = layer_pattern(cfg)
    pl = placement.of(cfg)
    x = placement.embed(pl, pl.gathered(params["embed"], ("embed",)),
                        tokens)                              # (B, N, D)
    if frontend is not None and not cfg.encoder_decoder:
        proj = pl.gathered(params["frontend_proj"], ("frontend_proj",))
        fe = frontend @ proj.to(frontend.dtype)
        x = torch.cat([fe.to(x.dtype), x], dim=1)
    if spiking:
        x = x[None].expand((cfg.spiking.t_steps,) + tuple(x.shape))
    enc_kv = None
    if cfg.encoder_decoder:
        enc_kv = _encoder_forward(cfg, params, frontend, spiking)
    x = _run_blocks(cfg, params["blocks"], x, spiking, pattern, n_groups,
                    causal, enc_kv)
    if spiking:
        x = _rate_decode(x)
    return rmsnorm(pl.gathered(params["final_norm"], ("final_norm",)), x)


def _logits(cfg: LMConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """f32 logits of h: whole vocab rows (`placement.logits`)."""
    pl = placement.of(cfg)
    return placement.logits(pl, pl.gathered(params["lm_head"],
                                            ("lm_head",)), h)


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor, spiking: bool,
            frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence prefill: last-position logits (B, vocab) f32."""
    hidden = forward_hidden(cfg, params, tokens, spiking, frontend=frontend)
    return _logits(cfg, params, hidden[:, -1, :])


# ------------------------------------------------------------------- loss
def _ce_chunk(hh: torch.Tensor, w_head: torch.Tensor, ll: torch.Tensor,
              logits_fn=None):
    """(sum of lse - target over the chunk's labelled positions, their
    count), both f32; f32 logits from ``hh @ w_head`` in hh's dtype, or
    from ``logits_fn(w_head, hh)``."""
    logits = (hh @ w_head.to(hh.dtype)).float() if logits_fn is None \
        else logits_fn(w_head, hh)
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
    tot, cnt = chunked_ce_terms(hidden, w_head, labels, chunk)
    return tot / torch.clamp(cnt, min=1.0)


def chunked_ce_terms(hidden: torch.Tensor, w_head: torch.Tensor,
                     labels: torch.Tensor, chunk: int, logits_fn=None):
    """`chunked_ce_loss`'s two sums, f32 scalars: the labelled positions'
    lse - target and their count (a data-parallel step divides the sum
    of the first over its ranks by the sum of the second). `logits_fn`
    (w_head, h) -> f32 logits replaces ``h @ w_head``."""
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
                                   logits_fn, use_reentrant=False)
        else:
            s, c = _ce_chunk(h_c[i], w_head, l_c[i], logits_fn)
        tot = tot + s
        cnt = cnt + c
    return tot, cnt


def loss_fn(cfg: LMConfig, params: dict, batch: Dict[str, torch.Tensor],
            spiking: bool) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` {"tokens", "labels"}, both
    (B, N) integers, and an optional "frontend" (B, F, D): a VLM's
    prepended frontend positions carry no loss (their labels are -1)."""
    tot, cnt = loss_terms(cfg, params, batch, spiking)
    return tot / torch.clamp(cnt, min=1.0)


def loss_terms(cfg: LMConfig, params: dict, batch: Dict[str, torch.Tensor],
               spiking: bool):
    """`loss_fn`'s (sum of the labelled positions' losses, their count),
    f32 scalars (`chunked_ce_terms`). On a rank mesh the LM head is
    gathered once for every chunk (the reference's pure-FSDP `loss_fn`
    gathers it so), and a vocab split over `model` gives each chunk its
    logits' whole rows (`placement.logits`)."""
    hidden = forward_hidden(cfg, params, batch["tokens"], spiking,
                            frontend=batch.get("frontend"))
    labels = batch["labels"]
    if cfg.n_frontend_tokens and "frontend" in batch:
        pad = labels.new_full((labels.shape[0], cfg.n_frontend_tokens), -1)
        labels = torch.cat([pad, labels], dim=1)
    pl = placement.of(cfg)
    w_head = pl.gathered(params["lm_head"], ("lm_head",))
    logits_fn = None if not pl.splits(cfg.vocab) else \
        functools.partial(placement.logits, pl)
    return chunked_ce_terms(hidden, w_head, labels, cfg.loss_chunk,
                            logits_fn)


# ---------------------------------------------------------------- serving
class LayerState(NamedTuple):
    """Union state for one pattern position (unused fields are None)."""
    kv: Any = None          # tfm.KVCache        (dense attn decode)
    sdsa: Any = None        # tfm.SDSAState      (spiking attn decode)
    mamba: Any = None
    mlstm: Any = None
    slstm: Any = None
    cross_kv: Any = None    # (k_enc, v_enc) (dense encoder-decoder)
    cross_status: Any = None  # (B, H, dh) (spiking encoder-decoder)


def init_state(cfg: LMConfig, spec: BlockSpec, b: int, s: int,
               spiking: bool, n_groups: int, device="cuda") -> LayerState:
    """Stacked (n_groups, b, ...) decode state for one pattern position:
    an attention block's SDSA statuses when spiking, else its KV cache of
    capacity `s`; an SSM block's recurrent state (in both modes); an
    encoder-decoder's attention blocks add their cross state, zeros (the
    reference never fills it)."""
    def stack(tree):
        return _tree_map(lambda x: x[None].expand(
            (n_groups,) + tuple(x.shape)).contiguous(), tree)
    dev = resolve_device(device)
    st = LayerState()
    # A rank whose attention runs its own heads holds their state alone
    # (the split `sharding.decode_state_specs` gives).
    pl = placement.of(cfg)
    m = pl.m if pl.ranked and pl.heads() else 1
    if spec.kind == "attn":
        if spiking:
            st = st._replace(sdsa=stack(tfm.sdsa_state_init(
                b, cfg.n_heads // m, cfg.head_dim, device=dev)))
        else:
            st = st._replace(kv=stack(tfm.kv_cache_init(
                b, s, cfg.n_kv_heads // m, cfg.head_dim, device=dev)))
    elif spec.kind == "mamba":
        hy = cfg.hybrid
        st = st._replace(mamba=stack(ssm.mamba_state_init(
            b, cfg.d_model, hy.d_state, hy.d_conv, hy.expand, device=dev)))
    elif spec.kind == "mlstm":
        st = st._replace(mlstm=stack(ssm.mlstm_state_init(
            b, cfg.d_model, cfg.n_heads, device=dev)))
    elif spec.kind == "slstm":
        st = st._replace(slstm=stack(ssm.slstm_state_init(
            b, cfg.d_model, device=dev)))
    if cfg.encoder_decoder and spec.kind == "attn":
        if spiking:
            st = st._replace(cross_status=stack(torch.zeros(
                (b, cfg.n_heads, cfg.head_dim), dtype=torch.bfloat16,
                device=dev)))
        else:
            st = st._replace(cross_kv=stack(tuple(torch.zeros(
                (b, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim),
                dtype=torch.bfloat16, device=dev) for _ in range(2))))
    return st


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
    """One layer of a decode step. x: (T, B, D) spiking / (B, D) dense.
    A spiking SSM block steps its recurrence once on the fired input's
    mean over T and broadcasts its output back over T (the reference's
    decode; its full-sequence form runs each micro-step)."""
    lif = lif_cfg_of(cfg)
    if spec.kind == "attn":
        x, st = _attn_decode(cfg, p, st, x, pos, spiking)
    elif spec.kind == "mamba":
        h = rmsnorm(p["ln1"], x)
        if spiking:
            h = _rate_decode(lif_fire(h, lif))
        out, new_m = ssm.mamba_apply(p["mamba"], h[:, None, :], st.mamba,
                                     cfg.hybrid.d_state, cfg.hybrid.d_conv)
        x = x + out[:, 0, :].expand(x.shape)
        st = st._replace(mamba=new_m)
    else:
        apply = getattr(ssm, f"{spec.kind}_apply")
        h = _rate_decode(lif_fire(x, lif)) if spiking else x
        out, new_s = apply(p[spec.kind], h[:, None, :], cfg.n_heads,
                           getattr(st, spec.kind))
        x = out[:, 0, :].expand(x.shape)
        st = st._replace(**{spec.kind: new_s})
    if spec.ffn == "none":
        return x, st
    return _ffn(cfg, spec, p, x, spiking, decode=True), st


def _attn_decode(cfg, p, st: LayerState, x, pos, spiking):
    """An attention block's decode: SDSA on its O(d) status when spiking
    (position-free), else dense GQA on the KV cache at `pos`; then the
    encoder-decoder's cross-attention."""
    lif = lif_cfg_of(cfg)
    if spiking:
        s = lif_fire(rmsnorm(p["ln1"], x), lif)              # (T, B, D)
        a, new_sdsa = _attention(
            cfg, p["attn"], s, lambda pp, xx, h, kv, sd:
            tfm.attention_sdsa_decode(
                pp, xx, sd, n_heads=h, n_kv=kv, d_head=cfg.head_dim,
                lif_cfg=lif, mode=cfg.spiking.sdsa_mode), state=st.sdsa)
        x = x + a
        st = st._replace(sdsa=new_sdsa)
        if st.cross_status is not None:
            pa = p["cross_attn"]
            q = lif_fire(rmsnorm(p["cross_ln"], x), lif)
            qh = (q @ pa["w_q"].to(q.dtype)).reshape(
                tuple(q.shape[:-1]) + (cfg.n_heads, cfg.head_dim))
            out = lif_fire(qh, lif) * st.cross_status[None].to(q.dtype)
            out = out.reshape(tuple(q.shape[:-1]) + (-1,))
            x = x + out @ pa["w_o"].to(x.dtype)
        return x, st
    a, new_kv = _attention(
        cfg, p["attn"], rmsnorm(p["ln1"], x), lambda pp, xx, h, kv, cache:
        tfm.attention_dense_decode(
            pp, xx, cache, pos, n_heads=h, n_kv=kv, d_head=cfg.head_dim,
            window=cfg.sliding_window, qk_norm=cfg.qk_norm,
            rope_theta=cfg.rope_theta,
            masked_cache_update=cfg.decode_masked_update), state=st.kv)
    x = x + a
    st = st._replace(kv=new_kv)
    if st.cross_kv is not None:
        x = x + _cross_attn_full(cfg, p, x[:, None, :], st.cross_kv,
                                 False)[:, 0, :]
    return x, st


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
    pl = placement.of(cfg)
    pos = torch.broadcast_to(torch.as_tensor(pos, device=token.device),
                             token.shape)
    x = placement.embed(pl, pl.gathered(params["embed"], ("embed",)),
                        token)                               # (B, D)
    if spiking:
        x = x[None].expand((cfg.spiking.t_steps,) + tuple(x.shape))
    per_group: List[List[LayerState]] = [[] for _ in pattern]
    for g in range(n_groups):
        for i, spec in enumerate(pattern):
            p = pl.gathered(_group(params["blocks"][i], g),
                            ("blocks", str(i)), layer=True)
            x, st = _apply_block_decode(cfg, spec, p, _group(state[i], g),
                                        x, pos, spiking)
            per_group[i].append(st)
    if spiking:
        x = _rate_decode(x)
    h = rmsnorm(pl.gathered(params["final_norm"], ("final_norm",)), x)
    return _logits(cfg, params, h), [_stack(sts) for sts in per_group]


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
