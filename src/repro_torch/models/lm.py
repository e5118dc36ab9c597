"""The decoder LM, for the architectures whose blocks are attention.

The JAX package's ``models/lm.py`` assembles all ten assigned
architectures as *segments*, each ``count`` repetitions of a *unit* (a
tuple of block kinds), and scans over stacked per-layer params.  The
port keeps ``LMConfig`` whole and the segment layout at its public face,
and serves block kinds ``attn`` (attention + SwiGLU), ``attn_geglu``
(attention + GeGLU) and ``moe_attn`` (attention + the MoE FFN of
``models/moe.py``), with the JAX model's extras for these families:
parallel codebooks (musicgen: summed embeddings in, one head per
codebook out, logits (B, S, K, V)) and a prefix of image patch
embeddings (internvl2: prepended to the text, cut off before the
read-out).  The other kinds (MLA, xLSTM, RG-LRU) and the MTP head come
with later slices of the port (``ROADMAP.md`` §1, the ML stack).

``LM`` is an ``nn.Module``: a ``ModuleList`` of blocks, one per layer in
order, looped over where JAX scans.  Its parameters keep the JAX tree's
names (``blocks.3.attn.wq.w`` is ``seg0/b0/attn/wq/w`` of layer 3).
Weights that every use casts to ``compute_dtype`` first (the ``w`` of
every linear and the embedding ``table``) are stored already cast, after
rounding through ``param_dtype``: the values are the ones JAX computes
with, and Yi-6B's matmul weights take 12 GB instead of 24.  The MoE's
expert stacks (``moe.experts.{gate,up,down}``) are cast at every use
too, and so stored cast.  Norm scales stay in ``param_dtype``.

The decode state keeps the JAX layout: ``state["seg0"]["b0"]["k"]`` is
(layers, batch, kv heads, max_len, d_head).  ``decode_step`` updates it
in place and returns it.

Training does not go through the module's parameters.  It holds float32
masters as the JAX package's own tree (``init_params``: nested dicts,
block leaves stacked per segment) and differentiates :meth:`LM.loss`,
which reads that tree; ``repro_torch.train`` owns the optimizer state
and the checkpoints in the same layout.  The serving module stays as it
is, cast and without gradients, so serving neither slows down nor grows;
a trained tree becomes a served model through
``models.weights.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
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
from repro_torch.utils.tree import flatten_with_paths, tree_map, unflatten_like

#: block kinds this port serves
BLOCK_KINDS = ("attn", "attn_geglu", "moe_attn")


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

    def moe_config(self) -> moe_mod.MoEConfig:
        return moe_mod.MoEConfig(
            d_model=self.d_model,
            d_ff=self.moe_d_ff or self.d_ff,
            num_experts=self.num_experts,
            top_k=self.top_k,
            num_shared=self.num_shared_experts,
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
        unported = sorted({k for *_, k in layer_plan(cfg)} - set(BLOCK_KINDS))
        if unported or cfg.mtp:
            raise NotImplementedError(
                f"{cfg.name}: the port serves attention blocks {BLOCK_KINDS} "
                f"without an MTP head (found kinds {unported}); MLA, the MTP "
                f"head, xLSTM and RG-LRU come with the slice 'the rest of the "
                f"ML stack', ROADMAP.md §1"
            )
        self.cfg = cfg
        # placeholders, so the state dict keeps the tree's order
        self.embed = nn.Module()
        self.blocks = nn.ModuleList(nn.Module() for _ in range(cfg.n_layers))
        for name, piece in self._pieces(None):
            self._adopt(name, piece)

    # -------------------------------------------------------------- params
    def _block_piece(self, kind: str, generator) -> Params:
        """One block's params, in the JAX ``_init_block`` layout."""
        cfg = self.cfg
        dt = cfg.param_dtype
        dev = device_of(generator)
        p: Params = {
            "norm1": init_rmsnorm(cfg.d_model, dtype=dt, device=dev),
            "attn": attn_mod.init_attention(generator, cfg.attention_config(), dtype=dt),
            "norm2": init_rmsnorm(cfg.d_model, dtype=dt, device=dev),
        }
        if kind == "moe_attn":
            p["moe"] = moe_mod.init_moe(generator, cfg.moe_config(), dtype=dt)
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
        and never reads it; the port keeps it, so trees round-trip), then
        ``heads`` (``cb{i}`` a codebook).  A piece is drawn only when the
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

    def _adopt(self, name: str, piece: Params) -> None:
        """Take ``piece`` (the port's layout) as the module's parameters
        under ``name``, with matmul weights (every ``w``, the MoE's expert
        stacks) and the embedding tables cast to compute_dtype."""
        cd = self.cfg.compute_dtype

        def cast(node, experts=False):
            return {
                k: cast(v, k == "experts") if isinstance(v, dict)
                else (v.to(cd) if experts or k in ("w", "table") else v)
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
        if kind == "moe_attn":
            out, aux = moe_mod.moe_apply(p["moe"], cfg.moe_config(), y, losses=losses)
            return out, (aux["balance_loss"] + aux["z_loss"]) if losses else None
        fn = swiglu if kind == "attn" else geglu
        return fn(p["mlp"], y, compute_dtype=cfg.compute_dtype), None

    def _apply_block(self, kind: str, p, h: torch.Tensor, positions: torch.Tensor,
                     *, losses: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One block over the full sequence; ``p`` is a block of the
        module or of a params tree (they index alike).  Returns (h, the
        block's aux loss or None)."""
        cfg = self.cfg
        x = rmsnorm(p["norm1"], h, eps=cfg.norm_eps)
        h = h + attn_mod.attend_train(p["attn"], cfg.attention_config(), x, positions)
        y = rmsnorm(p["norm2"], h, eps=cfg.norm_eps)
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
        h = self._embed_tokens(self._modules, tokens)
        n_prefix = 0
        if cfg.num_patches and patch_embeds is not None:
            h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
            n_prefix = patch_embeds.shape[1]
        positions = torch.arange(h.shape[1], device=h.device)
        for (*_, kind), p in zip(layer_plan(cfg), self.blocks):
            h, _ = self._apply_block(kind, p, h, positions)
        h = rmsnorm(self.final_norm, h, eps=cfg.norm_eps)
        if n_prefix:
            h = h[:, n_prefix:]
        return self._read_out(self._modules, h)

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
                    h, a = self._apply_block(kind, layer[f"b{i}"], h, positions, losses=True)
                    if a is not None:
                        aux = aux + a
                return h, aux

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
        without MoE blocks.

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
        h = self._embed_tokens(params, tokens)
        n_prefix = 0
        if cfg.num_patches and "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
            n_prefix = batch["patch_embeds"].shape[1]
        h, aux = self._stack(params, h, torch.arange(h.shape[1], device=h.device))
        h = rmsnorm(params["final_norm"], h, eps=cfg.norm_eps)
        if n_prefix:
            h = h[:, n_prefix:]
        logits = self._read_out(params, h[:, :-1])
        mask = batch.get("loss_mask")
        mask = None if mask is None else mask[:, 1:]
        if cfg.n_codebooks > 1 and mask is not None:
            mask = mask[..., None] * torch.ones((1, 1, cfg.n_codebooks), device=mask.device)
        ce = cross_entropy(logits, tokens[:, 1:], mask=mask)
        total = ce + aux
        return total, {"ce": ce, "aux": aux, "loss": total}

    # ---------------------------------------------------------- serving
    def init_decode_state(self, batch: int, max_len: Optional[int] = None) -> Params:
        """Zeroed KV caches on the model's device, in compute_dtype:
        ``state[f"seg{i}"][f"b{j}"]["k"|"v"]`` of shape
        (count, batch, n_kv_heads, max_len, d_head)."""
        cfg = self.cfg
        max_len = max_len or cfg.max_decode_len
        shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        state: Params = {}
        for si, (unit, count) in enumerate(cfg.segments):
            state[f"seg{si}"] = {
                f"b{i}": {
                    name: torch.zeros((count, *shape), dtype=cfg.compute_dtype,
                                      device=self.device)
                    for name in ("k", "v")
                }
                for i in range(len(unit))
            }
        return state

    @torch.no_grad()
    def decode_step(
        self,
        state: Params,
        tokens: torch.Tensor,   # (B, 1), or (B, 1, K) with codebooks
        lengths: torch.Tensor,  # (B,)
    ) -> Tuple[torch.Tensor, Params]:
        """One decoding step. Returns (logits (B, 1[, K], V), state), the
        state updated in place.  An MoE block routes the whole batch as
        one group (``moe_apply``'s decode case)."""
        cfg = self.cfg
        acfg = cfg.attention_config()
        h = self._embed_tokens(self._modules, tokens)
        for (si, i, r, kind), p in zip(layer_plan(cfg), self.blocks):
            stacked = state[f"seg{si}"][f"b{i}"]
            cache = {"k": stacked["k"][r], "v": stacked["v"][r]}
            x = rmsnorm(p["norm1"], h, eps=cfg.norm_eps)
            out, _ = attn_mod.decode_step(p["attn"], acfg, x, cache, lengths)
            h = h + out
            y = rmsnorm(p["norm2"], h, eps=cfg.norm_eps)
            h = h + self._ffn(kind, p, y, losses=False)[0]
        h = rmsnorm(self.final_norm, h, eps=cfg.norm_eps)
        return self._read_out(self._modules, h), state
