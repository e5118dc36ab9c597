"""The decoder LM, for every block kind of the JAX package.

The JAX package's ``models/lm.py`` assembles all ten assigned
architectures as *segments*, each ``count`` repetitions of a *unit* (a
tuple of block kinds), and scans over stacked per-layer params.  The
port keeps ``LMConfig`` whole and the segment layout at its public face,
and serves every block kind: ``attn`` (attention + SwiGLU),
``attn_geglu`` (attention + GeGLU), ``moe_attn`` (attention + the MoE FFN
of ``models/moe.py``), ``rec`` (the RG-LRU of ``models/rglru.py`` +
GeGLU), ``mla_dense`` (the MLA of ``models/mla.py`` + a SwiGLU of width
``dense_d_ff``), ``mla_moe`` (MLA + the MoE FFN), and ``mlstm`` and
``slstm`` (the xLSTM blocks of ``models/xlstm.py``, no FFN), with the
JAX model's extras: parallel codebooks (musicgen: summed embeddings in,
one head per codebook out, logits (B, S, K, V)), a prefix of image patch
embeddings (internvl2: prepended to the text, cut off before the
read-out) and DeepSeek's multi-token-prediction head (``mtp``: a
projection of [h_t, emb(t+1)], one unstacked block and a norm, read by
``loss`` only).

``LM`` is an ``nn.Module``: a ``ModuleList`` of blocks, one per layer in
order, looped over where JAX scans.  Its parameters keep the JAX tree's
names (``blocks.3.attn.wq.w`` is ``seg0/b0/attn/wq/w`` of layer 3).
Weights that every use casts to ``compute_dtype`` first (the ``w`` of
every linear and the embedding ``table``) are stored already cast, after
rounding through ``param_dtype``: the values are the ones JAX computes
with, and Yi-6B's matmul weights take 12 GB instead of 24.  The MoE's
expert stacks (``moe.experts.{gate,up,down}``) are cast at every use
too, and so stored cast.  Norm scales stay in ``param_dtype``, and so do
the RG-LRU's ``conv``, ``lam`` and the weights of its float32 gate
projections (``rglru.FLOAT32_LINEARS``), which JAX reads as float32.

The decode state keeps the JAX layout: ``state["seg0"]["b0"]["k"]`` is
(layers, batch, kv heads, max_len, d_head); a ``rec`` block's
``["h"]`` is (layers, batch, d_rnn) and ``["conv"]`` (layers, batch,
width - 1, d_rnn); an ``mlstm`` block's ``["C"]``, ``["n"]``, ``["m"]``
are (layers, batch, heads, dh, dh), (layers, batch, heads, dh) and
(layers, batch, heads); an ``slstm`` block's ``["c"]``, ``["n"]``,
``["h"]``, ``["m"]`` (layers, batch, d_model), all float32; an MLA
block's ``["c_kv"]`` (layers, batch, max_len, kv rank) and
``["k_rope"]`` (layers, batch, 1, max_len, rope dim) in compute_dtype.
``decode_step`` updates it in place and returns it.

Training does not go through the module's parameters.  It holds float32
masters as the JAX package's own tree (``init_params``: nested dicts,
block leaves stacked per segment) and differentiates :meth:`LM.loss`,
which reads that tree; ``repro_torch.train`` owns the optimizer state
and the checkpoints in the same layout.  The serving module stays as it
is, cast and without gradients, so serving neither slows down nor grows;
a trained tree becomes a served model through
``models.weights.params_from_numpy``.

``forward`` marks its pieces for a running profiler with the spans of
``repro_torch.telemetry.spans`` (``lm.embed``, ``lm.norm``,
``lm.attention`` and its parts, ``lm.mlp``, ``lm.head``); the blocks'
spans mark the training stack's layers too; ``decode_step``, and so
serving, enters none.  With no profiler they cost a flag check each.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.distribution.sharding import constrain_batch, constrain_logits
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (
    Params,
    as_module,
    cross_entropy,
    device_of,
    embed,
    geglu,
    init_embedding,
    init_geglu,
    init_linear,
    init_rmsnorm,
    init_swiglu,
    linear,
    logits_head,
    rmsnorm,
    swiglu,
)
from repro_torch.telemetry.spans import span
from repro_torch.utils.tree import flatten_with_paths, tree_map, unflatten_like

#: block kinds this port serves: every kind of the JAX package
BLOCK_KINDS = ("attn", "attn_geglu", "moe_attn", "mla_dense", "mla_moe", "mlstm", "slstm",
               "rec")
#: kinds whose mixer is MLA, whose FFN is the MoE, that have no FFN
MLA_KINDS = ("mla_dense", "mla_moe")
MOE_KINDS = ("moe_attn", "mla_moe")
XLSTM_KINDS = ("mlstm", "slstm")


class ModelFamily(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    VLM = "vlm"
    AUDIO = "audio"


Segments = Tuple[Tuple[Tuple[str, ...], int], ...]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: ModelFamily
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: Segments
    d_head: Optional[int] = None  # default d_model // n_heads
    # attention options
    qk_norm: bool = False
    window: Optional[int] = None
    rope_theta: float = 10000.0
    attn_logit_soft_cap: Optional[float] = None
    # MoE options
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0  # FFN width of dense layers in hybrid-MoE stacks
    # extras
    mtp: bool = False  # DeepSeek multi-token prediction head
    mtp_loss_weight: float = 0.1
    n_codebooks: int = 1  # musicgen: parallel EnCodec codebooks
    num_patches: int = 0  # vlm: prepended image patch embeddings
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    use_flash_kernel: bool = False
    remat: str = "none"  # "none" | "full" | "dots"
    # serving
    max_decode_len: int = 4096

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def attention_config(self, *, window_override=-1) -> attn_mod.AttentionConfig:
        return attn_mod.AttentionConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.head_dim,
            rope_theta=self.rope_theta,
            qk_norm=self.qk_norm,
            window=self.window if window_override == -1 else window_override,
            use_flash_kernel=self.use_flash_kernel,
            compute_dtype=self.compute_dtype,
        )

    def mla_config(self) -> mla_mod.MLAConfig:
        return mla_mod.MLAConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            compute_dtype=self.compute_dtype,
        )

    def moe_config(self) -> moe_mod.MoEConfig:
        return moe_mod.MoEConfig(
            d_model=self.d_model,
            d_ff=self.moe_d_ff or self.d_ff,
            num_experts=self.num_experts,
            top_k=self.top_k,
            num_shared=self.num_shared_experts,
            compute_dtype=self.compute_dtype,
        )

    def xlstm_config(self) -> xlstm_mod.XLSTMConfig:
        return xlstm_mod.XLSTMConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            compute_dtype=self.compute_dtype,
        )

    @property
    def mtp_kind(self) -> str:
        """The MTP head's block kind: ``mla_dense`` when the first block
        is MLA, else ``attn`` (the JAX ``init`` and ``loss``)."""
        return "mla_dense" if self.segments[0][0][0].startswith("mla") else "attn"

    def rglru_config(self) -> rglru_mod.RGLRUConfig:
        return rglru_mod.RGLRUConfig(
            d_model=self.d_model,
            d_rnn=self.d_model,
            compute_dtype=self.compute_dtype,
        )


def _unstack(tree: Params, count: int) -> List[Params]:
    """A tree of stacked leaves as ``count`` trees of one layer each."""
    parts = {k: torch.unbind(v, 0) for k, v in flatten_with_paths(tree).items()}
    return [unflatten_like(tree, {k: v[r] for k, v in parts.items()}) for r in range(count)]


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for remat "dots": keep the
    products with no batch dims (``aten.mm``: activations times a weight),
    recompute the rest (attention's batched products included), as
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(mode: str, fn: Callable, h: torch.Tensor, layer: Params) -> torch.Tensor:
    """``fn(h, layer)`` under the JAX package's remat modes: "none" keeps
    every activation, "full" keeps the layer's inputs and recomputes the
    rest in the backward, "dots" also keeps the matmul outputs.  None of
    them changes a number."""
    if mode == "none":
        return fn(h, layer)
    if mode == "full":
        return ckpt.checkpoint(fn, h, layer, use_reentrant=False)
    if mode == "dots":
        return ckpt.checkpoint(
            fn, h, layer, use_reentrant=False,
            context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                         _save_matmuls),
        )
    raise ValueError(f"unknown remat mode {mode!r}")


def layer_plan(cfg: LMConfig) -> List[Tuple[int, int, int, str]]:
    """(segment, position in unit, repetition, kind) of every layer, in
    order: layer ``n`` reads ``seg{segment}/b{position}[repetition]`` of
    the JAX tree and of the decode state."""
    return [
        (si, i, r, kind)
        for si, (unit, count) in enumerate(cfg.segments)
        for r in range(count)
        for i, kind in enumerate(unit)
    ]


class LM(nn.Module):
    """(init, forward, init_decode_state, decode_step) over an LMConfig.

    ``LM(cfg)`` holds the structure on the ``meta`` device; ``init``
    draws the weights, or ``load_state_dict(..., assign=True)`` (and
    :func:`repro_torch.models.weights.params_from_numpy`) brings them.
    """

    def __init__(self, cfg: LMConfig):
        super().__init__()
        total = sum(len(unit) * count for unit, count in cfg.segments)
        if total != cfg.n_layers:
            raise ValueError(
                f"{cfg.name}: segments sum to {total} layers, expected {cfg.n_layers}"
            )
        self.cfg = cfg
        # placeholders, so the state dict keeps the tree's order
        self.embed = nn.Module()
        self.blocks = nn.ModuleList(nn.Module() for _ in range(cfg.n_layers))
        for name, piece in self._pieces(None):
            self._adopt(name, piece)

    # -------------------------------------------------------------- params
    def _block_piece(self, kind: str, generator) -> Params:
        """One block's params, in the JAX ``_init_block`` layout; an
        unknown kind is a ``ValueError``, as in the JAX package."""
        cfg = self.cfg
        dt = cfg.param_dtype
        dev = device_of(generator)
        p: Params = {"norm1": init_rmsnorm(cfg.d_model, dtype=dt, device=dev)}
        if kind == "mlstm":  # the xLSTM blocks have no norm2 and no FFN
            p["mix"] = xlstm_mod.init_mlstm(generator, cfg.xlstm_config(), dtype=dt)
            return p
        if kind == "slstm":
            p["mix"] = xlstm_mod.init_slstm(generator, cfg.xlstm_config(), dtype=dt)
            return p
        if kind == "rec":
            p["mix"] = rglru_mod.init_rglru(generator, cfg.rglru_config(), dtype=dt)
        elif kind in MLA_KINDS:
            p["attn"] = mla_mod.init_mla(generator, cfg.mla_config(), dtype=dt)
        elif kind in ("attn", "attn_geglu", "moe_attn"):
            p["attn"] = attn_mod.init_attention(generator, cfg.attention_config(), dtype=dt)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype=dt, device=dev)
        if kind in MOE_KINDS:
            p["moe"] = moe_mod.init_moe(generator, cfg.moe_config(), dtype=dt)
        elif kind == "mla_dense":
            p["mlp"] = init_swiglu(generator, cfg.d_model, cfg.dense_d_ff or cfg.d_ff, dtype=dt)
        else:
            mlp = init_swiglu if kind == "attn" else init_geglu
            p["mlp"] = mlp(generator, cfg.d_model, cfg.d_ff, dtype=dt)
        return p

    def _pieces(self, generator: Optional[torch.Generator]) -> Iterator[Tuple[str, Params]]:
        """The JAX tree's shapes and scales as ``(name, params)`` pieces,
        drawn from ``generator`` (or on the meta device when it is None) in
        the JAX init's order: ``embed`` (one table, or ``cb{i}`` a
        codebook), ``blocks.<i>`` in ``layer_plan`` order, ``final_norm``,
        ``lm_head`` (untied heads: with codebooks the JAX model builds it
        and never reads it; the port keeps it, so trees round-trip),
        ``heads`` (``cb{i}`` a codebook), then ``mtp`` (``proj``, one
        block of ``cfg.mtp_kind``, ``norm``).  A piece is drawn only when the
        one before it has been taken, and the generator keeps no reference
        to it: a caller that drops a piece before asking for the next
        holds at most one piece in ``param_dtype`` at a time."""
        cfg = self.cfg
        dt = cfg.param_dtype
        if cfg.n_codebooks > 1:
            yield "embed", {f"cb{i}": init_embedding(generator, cfg.vocab, cfg.d_model, dtype=dt)
                            for i in range(cfg.n_codebooks)}
        else:
            yield "embed", init_embedding(generator, cfg.vocab, cfg.d_model, dtype=dt)
        for i, (*_, kind) in enumerate(layer_plan(cfg)):
            yield f"blocks.{i}", self._block_piece(kind, generator)
        yield "final_norm", init_rmsnorm(cfg.d_model, dtype=dt, device=device_of(generator))
        if not cfg.tie_embeddings:
            yield "lm_head", init_linear(generator, cfg.d_model, cfg.vocab, dtype=dt)
        if cfg.n_codebooks > 1:
            yield "heads", {f"cb{i}": init_linear(generator, cfg.d_model, cfg.vocab, dtype=dt)
                            for i in range(cfg.n_codebooks)}
        if cfg.mtp:
            proj = init_linear(generator, 2 * cfg.d_model, cfg.d_model, dtype=dt)
            yield "mtp", {"proj": proj, "block": self._block_piece(cfg.mtp_kind, generator),
                          "norm": init_rmsnorm(cfg.d_model, dtype=dt, device=device_of(generator))}

    def _adopt(self, name: str, piece: Params) -> None:
        """Take ``piece`` (the port's layout) as the module's parameters
        under ``name``, with matmul weights (every ``w`` but those of the
        RG-LRU's float32 linears, the MoE's expert stacks) and the embedding
        tables cast to compute_dtype."""
        cd = self.cfg.compute_dtype

        def cast(node, experts=False, f32=False):
            return {
                k: cast(v, k == "experts", k in rglru_mod.FLOAT32_LINEARS)
                if isinstance(v, dict)
                else (v.to(cd) if experts or (k in ("w", "table") and not f32) else v)
                for k, v in node.items()
            }

        module = as_module(cast(piece))
        if name.startswith("blocks."):
            self.blocks[int(name.split(".")[1])] = module
        else:
            setattr(self, name, module)

    def init(self, generator: torch.Generator) -> "LM":
        """Draw every weight from ``generator``, on its device.  Same
        shapes and scales as the JAX ``LM.init``; not the same numbers
        (torch's and JAX's generators differ).  Each piece (the embedding,
        a block, the final norm, the heads) is drawn, cast and adopted
        before the next is drawn, so the float32 draws never add more than
        one piece to the compute_dtype weights."""
        for name, piece in self._pieces(generator):
            self._adopt(name, piece)
            del piece  # the float32 draws go before the next piece's
        return self

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    # ----------------------------------------------------------- pieces
    # ``root`` is the module's children (``self._modules``) or a params
    # tree: both index as ``root["embed"]``, ``root["lm_head"]``, ...
    def _embed_tokens(self, root, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S), or (B, S, K) with codebooks (their embeddings
        summed), as hidden states in compute_dtype."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        if cfg.n_codebooks > 1:
            return sum(embed(root["embed"][f"cb{i}"], tokens[..., i], compute_dtype=cd)
                       for i in range(cfg.n_codebooks))
        return embed(root["embed"], tokens, compute_dtype=cd)

    def _read_out(self, root, h: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, V), or (B, S, K, V) with codebooks."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        if cfg.n_codebooks > 1:
            return torch.stack([linear(root["heads"][f"cb{i}"], h, compute_dtype=cd)
                                for i in range(cfg.n_codebooks)], dim=-2)
        if cfg.tie_embeddings:
            return logits_head(root["embed"], h, compute_dtype=cd)
        return linear(root["lm_head"], h, compute_dtype=cd)

    def _ffn(self, kind: str, p, y: torch.Tensor, *, losses: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block's FFN on ``y``: (output, the MoE's balance + z loss
        when ``losses`` and the block has an MoE, else None)."""
        cfg = self.cfg
        if kind in MOE_KINDS:
            out, aux = moe_mod.moe_apply(p["moe"], cfg.moe_config(), y, losses=losses)
            return out, (aux["balance_loss"] + aux["z_loss"]) if losses else None
        # attn and mla_dense: SwiGLU; attn_geglu and rec: GeGLU
        fn = swiglu if kind in ("attn", "mla_dense") else geglu
        return fn(p["mlp"], y, compute_dtype=cfg.compute_dtype), None

    def _apply_block(self, kind: str, p, h: torch.Tensor, positions: torch.Tensor,
                     *, losses: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One block over the full sequence; ``p`` is a block of the
        module or of a params tree (they index alike).  Returns (h, the
        block's aux loss or None)."""
        cfg = self.cfg
        with span("lm.norm"):
            x = rmsnorm(p["norm1"], h, eps=cfg.norm_eps)
        if kind == "mlstm":
            return h + xlstm_mod.mlstm_block(p["mix"], cfg.xlstm_config(), x), None
        if kind == "slstm":
            return h + xlstm_mod.slstm_block(p["mix"], cfg.xlstm_config(), x), None
        if kind == "rec":
            h = h + rglru_mod.rglru_block(p["mix"], cfg.rglru_config(), x)
        elif kind in MLA_KINDS:
            h = h + mla_mod.mla_train(p["attn"], cfg.mla_config(), x, positions)
        else:
            with span("lm.attention"):
                a = attn_mod.attend_train(p["attn"], cfg.attention_config(), x, positions)
            h = h + a
        with span("lm.norm"):
            y = rmsnorm(p["norm2"], h, eps=cfg.norm_eps)
        with span("lm.mlp"):
            out, aux = self._ffn(kind, p, y, losses=losses)
        return h + out, aux

    # ---------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence logits (B, S, V), or (B, S, K, V) for tokens
        (B, S, K) with codebooks.  With ``num_patches``, ``patch_embeds``
        (B, P, d) go before the text and the logits cover the text only."""
        cfg = self.cfg
        with span("lm.embed"):
            h = constrain_batch(self._embed_tokens(self._modules, tokens))
        n_prefix = 0
        if cfg.num_patches and patch_embeds is not None:
            h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
            n_prefix = patch_embeds.shape[1]
        positions = torch.arange(h.shape[1], device=h.device)
        for (si, i, _, kind), p in zip(layer_plan(cfg), self.blocks):
            h, _ = self._apply_block(kind, p, constrain_batch(h), positions)
            if i == len(cfg.segments[si][0]) - 1:  # a unit's end, as the JAX scan's
                h = constrain_batch(h)
        with span("lm.norm"):
            h = rmsnorm(self.final_norm, h, eps=cfg.norm_eps)
        if n_prefix:
            h = h[:, n_prefix:]
        with span("lm.head"):
            return constrain_logits(self._read_out(self._modules, h))

    # --------------------------------------------------------- training
    def init_params(self, generator: Optional[torch.Generator]) -> Params:
        """The JAX package's params tree in ``param_dtype``, drawn from
        ``generator`` on its device (meta tensors, no memory, when it is
        None): ``embed``, then ``seg{i}`` whose block leaves are stacked on
        a leading layer axis (``seg0/b0/attn/wq/w`` is (count, d_in,
        d_out)), ``final_norm``, ``lm_head`` and ``heads``.  The draws are
        :meth:`init`'s, in the same order, before any cast."""
        plan = layer_plan(self.cfg)
        tree: Params = {}
        for name, piece in self._pieces(generator):
            if not name.startswith("blocks."):
                tree[name] = piece
                continue
            si, i, r, _ = plan[int(name.split(".")[1])]
            seg = tree.setdefault(f"seg{si}", {})
            if r == 0:
                count = self.cfg.segments[si][1]
                seg[f"b{i}"] = tree_map(lambda x: x.new_empty((count, *x.shape)), piece)
            tree_map(lambda stack, x: stack[r].copy_(x), seg[f"b{i}"], piece)
        return tree

    def _stack(self, params: Params, h: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every segment of a params tree over ``h``, a layer at a time,
        each layer's leaves cut from the stacks by ``torch.unbind`` (whose
        backward stacks the layers' gradients once), under the config's
        remat mode (``_remat``).  Returns (h, the float32 sum of the
        blocks' aux losses)."""
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        for si, (unit, count) in enumerate(self.cfg.segments):

            def unit_fn(h, layer, _unit=unit):
                aux = torch.zeros((), dtype=torch.float32, device=h.device)
                for i, kind in enumerate(_unit):
                    h, a = self._apply_block(kind, layer[f"b{i}"], constrain_batch(h), positions,
                                             losses=True)
                    if a is not None:
                        aux = aux + a
                return constrain_batch(h), aux

            for layer in _unstack(params[f"seg{si}"], count):
                h, aux = _remat(self.cfg.remat, unit_fn, h, layer)
                aux_total = aux_total + aux
        return h, aux_total

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The next-token objective on a params tree (the JAX package's
        ``LM.loss``): batch ``tokens`` (B, S) int, or (B, S, K) with
        codebooks (cross-entropy over every codebook, the mask broadcast
        over K), optional ``loss_mask`` (B, S), optional ``patch_embeds``
        (B, P, d) before the text.  Returns ``(total, {"ce", "aux",
        "loss"})``; ``aux`` is the MoE blocks' balance and z losses, 0
        without MoE blocks.  With an MTP head (``cfg.mtp``) the metrics add
        ``mtp_ce``, the cross-entropy of predicting token t + 2 from
        [h_t, emb(token t + 1)] through the head's block (its own aux loss
        dropped, as in the JAX package), and the total adds
        ``mtp_loss_weight * mtp_ce``.

        With gradients enabled it refuses ``use_flash_kernel``: the CUDA
        flash kernel has no backward (nor has the JAX package's Pallas
        kernel a VJP), so q, k and v would get no gradient."""
        cfg = self.cfg
        if cfg.use_flash_kernel and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{cfg.name}: training with use_flash_kernel=True — the flash "
                f"attention kernel has no backward; train with use_flash_kernel="
                f"False (the reference attention) and serve on the kernels"
            )
        tokens = batch["tokens"]
        h = constrain_batch(self._embed_tokens(params, tokens))
        n_prefix = 0
        if cfg.num_patches and "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
            n_prefix = batch["patch_embeds"].shape[1]
        positions = torch.arange(h.shape[1], device=h.device)
        h, aux = self._stack(params, h, positions)
        h = rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
        if n_prefix:
            h = h[:, n_prefix:]
        logits = constrain_logits(self._read_out(params, constrain_batch(h[:, :-1])))
        mask = batch.get("loss_mask")
        mask = None if mask is None else mask[:, 1:]
        ce_mask = mask
        if cfg.n_codebooks > 1 and mask is not None:
            ce_mask = mask[..., None] * torch.ones((1, 1, cfg.n_codebooks), device=mask.device)
        ce = cross_entropy(logits, tokens[:, 1:], mask=ce_mask)
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp:  # predict t + 2 from (h_t, emb_{t+1})
            mtp = params["mtp"]
            h_mtp = torch.cat([h[:, :-2], self._embed_tokens(params, tokens[:, 1:-1])], dim=-1)
            h_mtp = constrain_batch(linear(mtp["proj"], h_mtp, compute_dtype=cfg.compute_dtype))
            h_mtp, _ = self._apply_block(cfg.mtp_kind, mtp["block"], h_mtp,
                                         positions[:h_mtp.shape[1]])
            h_mtp = rmsnorm(mtp["norm"], h_mtp, eps=cfg.norm_eps)
            mtp_ce = cross_entropy(self._read_out(params, h_mtp), tokens[:, 2:],
                                   mask=None if mask is None else mask[:, 1:])
            metrics["mtp_ce"] = mtp_ce
            total = total + cfg.mtp_loss_weight * mtp_ce
        metrics["loss"] = total
        return total, metrics

    # ---------------------------------------------------------- serving
    def _block_state(self, kind: str, count: int, batch: int, max_len: int) -> Params:
        """One block's decode state, stacked over the ``count`` layers of
        its segment: zeroed KV caches or MLA latent caches in
        compute_dtype, or a recurrent block's float32 state."""
        cfg = self.cfg
        dev = self.device
        if kind == "rec":
            one = rglru_mod.init_rglru_state(cfg.rglru_config(), batch, device=dev)
        elif kind == "mlstm":
            one = xlstm_mod.init_mlstm_state(cfg.xlstm_config(), batch, device=dev)
        elif kind == "slstm":
            one = xlstm_mod.init_slstm_state(cfg.xlstm_config(), batch, device=dev)
        elif kind in MLA_KINDS:
            one = mla_mod.init_mla_cache(cfg.mla_config(), batch, max_len,
                                         dtype=cfg.compute_dtype, device=dev)
        else:
            shape = (count, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
                    for name in ("k", "v")}
        return {k: v.expand(count, *v.shape).clone() for k, v in one.items()}

    def init_decode_state(self, batch: int, max_len: Optional[int] = None) -> Params:
        """The zeroed decode state on the model's device, in the JAX
        layout (the module's docstring lists each kind's leaves):
        ``state[f"seg{i}"][f"b{j}"][leaf]``, every leaf stacked over the
        segment's ``count`` layers."""
        cfg = self.cfg
        max_len = max_len or cfg.max_decode_len
        return {
            f"seg{si}": {f"b{i}": self._block_state(kind, count, batch, max_len)
                         for i, kind in enumerate(unit)}
            for si, (unit, count) in enumerate(cfg.segments)
        }

    @torch.no_grad()
    def decode_step(
        self,
        state: Params,
        tokens: torch.Tensor,   # (B, 1), or (B, 1, K) with codebooks
        lengths: torch.Tensor,  # (B,)
    ) -> Tuple[torch.Tensor, Params]:
        """One decoding step. Returns (logits (B, 1[, K], V), state), the
        state updated in place.  An MoE block routes the whole batch as
        one group (``moe_apply``'s decode case) and drops its aux loss."""
        cfg = self.cfg
        h = constrain_batch(self._embed_tokens(self._modules, tokens))
        for (si, i, r, kind), p in zip(layer_plan(cfg), self.blocks):
            # this layer's views of the stacked state: updated in place
            layer = {k: v[r] for k, v in state[f"seg{si}"][f"b{i}"].items()}
            h = constrain_batch(h)
            x = rmsnorm(p["norm1"], h, eps=cfg.norm_eps)
            if kind == "mlstm":
                out, _ = xlstm_mod.mlstm_decode_step(p["mix"], cfg.xlstm_config(), x, layer)
            elif kind == "slstm":
                out, _ = xlstm_mod.slstm_decode_step(p["mix"], cfg.xlstm_config(), x, layer)
            elif kind == "rec":
                out, _ = rglru_mod.rglru_decode_step(p["mix"], cfg.rglru_config(), x, layer)
            elif kind in MLA_KINDS:
                out, _ = mla_mod.mla_decode_step(p["attn"], cfg.mla_config(), x, layer, lengths)
            else:
                out, _ = attn_mod.decode_step(p["attn"], cfg.attention_config(), x, layer,
                                              lengths)
            h = h + out
            if kind in XLSTM_KINDS:
                continue
            y = rmsnorm(p["norm2"], h, eps=cfg.norm_eps)
            h = h + self._ffn(kind, p, y, losses=False)[0]
        h = rmsnorm(self.final_norm, h, eps=cfg.norm_eps)
        return self._read_out(self._modules, h), state
