"""``LM.init`` draws, casts and adopts one piece at a time, on the CPU.

* On the smoke configs of every ported arch, the per-piece ``LM.init``
  gives parameters bitwise equal, in the same order, to the algorithm it
  replaced (``whole_tree_then_cast`` below, a copy kept here: draw the
  whole tree in ``param_dtype``, then cast the matmul weights, the MoE's
  expert stacks and the embedding tables to ``compute_dtype``; extended
  to the MoE blocks, codebooks, codebook heads, RG-LRU blocks, xLSTM
  blocks, MLA blocks and the MTP head as they were ported),
  from the same seeded generator.
* A spy on the draws (``common._normal``) watches which float32 draws are
  still alive when the next one is made: under ``LM.init`` only the
  current piece's, and none once init returns; under the old algorithm
  every earlier piece's, so the spy tells the two apart.
"""
import weakref

import pytest
import torch

from repro_torch.configs import PORTED, get_smoke_config
from repro_torch.models import LM
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.lm import layer_plan

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

SEED = 1234


def whole_tree_then_cast(cfg, generator):
    """The algorithm ``LM.init`` replaced: the whole tree in param_dtype
    first, then the cast; returned as a flat ``state_dict``-style dict."""
    dt, dev = cfg.param_dtype, generator.device
    codebooks = range(cfg.n_codebooks) if cfg.n_codebooks > 1 else ()
    if codebooks:
        embed = {f"cb{i}": common.init_embedding(generator, cfg.vocab, cfg.d_model, dtype=dt)
                 for i in codebooks}
    else:
        embed = common.init_embedding(generator, cfg.vocab, cfg.d_model, dtype=dt)
    tree = {"embed": embed, "blocks": [whole_block(cfg, kind, generator)
                                       for *_, kind in layer_plan(cfg)]}
    tree["final_norm"] = common.init_rmsnorm(cfg.d_model, dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        tree["lm_head"] = common.init_linear(generator, cfg.d_model, cfg.vocab, dtype=dt)
    if codebooks:
        tree["heads"] = {f"cb{i}": common.init_linear(generator, cfg.d_model, cfg.vocab, dtype=dt)
                         for i in codebooks}
    if cfg.mtp:
        proj = common.init_linear(generator, 2 * cfg.d_model, cfg.d_model, dtype=dt)
        tree["mtp"] = {"proj": proj, "block": whole_block(cfg, cfg.mtp_kind, generator),
                       "norm": common.init_rmsnorm(cfg.d_model, dtype=dt, device=dev)}
    flat = {}
    _flatten(cfg, flat, "embed.", tree["embed"])
    for i, block in enumerate(tree["blocks"]):
        _flatten(cfg, flat, f"blocks.{i}.", block)
    for name in ("final_norm", "lm_head", "heads", "mtp"):
        if name in tree:
            _flatten(cfg, flat, f"{name}.", tree[name])
    return flat


def whole_block(cfg, kind, generator):
    """One block in param_dtype, drawn as the JAX ``_init_block`` lays it
    out."""
    dt, dev = cfg.param_dtype, generator.device
    block = {"norm1": common.init_rmsnorm(cfg.d_model, dtype=dt, device=dev)}
    if kind in ("mlstm", "slstm"):
        init = xlstm_mod.init_mlstm if kind == "mlstm" else xlstm_mod.init_slstm
        block["mix"] = init(generator, cfg.xlstm_config(), dtype=dt)
        return block
    if kind == "rec":
        block["mix"] = rglru_mod.init_rglru(generator, cfg.rglru_config(), dtype=dt)
    elif kind.startswith("mla"):
        block["attn"] = mla_mod.init_mla(generator, cfg.mla_config(), dtype=dt)
    else:
        block["attn"] = attn_mod.init_attention(generator, cfg.attention_config(), dtype=dt)
    block["norm2"] = common.init_rmsnorm(cfg.d_model, dtype=dt, device=dev)
    if kind in ("moe_attn", "mla_moe"):
        block["moe"] = moe_mod.init_moe(generator, cfg.moe_config(), dtype=dt)
    elif kind == "mla_dense":
        block["mlp"] = common.init_swiglu(generator, cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                                          dtype=dt)
    else:
        mlp = common.init_swiglu if kind == "attn" else common.init_geglu
        block["mlp"] = mlp(generator, cfg.d_model, cfg.d_ff, dtype=dt)
    return block


def _flatten(cfg, flat, prefix, node, experts=False, f32=False):
    """``node``'s leaves into ``flat`` in the module's order, cast as
    ``LM._adopt`` casts them."""
    leaves = all(isinstance(v, torch.Tensor) for v in node.values())
    # a dict of leaves becomes a ParameterDict, which sorts its keys; a
    # node of leaves beside sub-trees (the RG-LRU's mix) a MixedNode, whose
    # leaves come first
    items = (sorted(node.items()) if leaves else
             sorted(node.items(), key=lambda kv: isinstance(kv[1], dict)))
    for k, v in items:
        if isinstance(v, dict):
            _flatten(cfg, flat, f"{prefix}{k}.", v, k == "experts",
                     k in rglru_mod.FLOAT32_LINEARS)
        else:
            # the RG-LRU's float32 linears keep their w in param_dtype
            cast = experts or (k in ("w", "table") and not f32)
            flat[prefix + k] = v.to(cfg.compute_dtype) if cast else v


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


@pytest.mark.parametrize("arch", PORTED)
def test_per_piece_init_is_bitwise_the_whole_tree_algorithm(arch):
    cfg = get_smoke_config(arch)
    got = LM(cfg).init(torch.Generator().manual_seed(SEED)).state_dict()
    want = whole_tree_then_cast(cfg, torch.Generator().manual_seed(SEED))
    assert list(got) == list(want)
    for name in want:
        assert bitwise_equal(got[name], want[name]), name
    # matmul weights and the table in compute_dtype, norm scales in param_dtype
    first = {kind: i for i, (*_, kind) in reversed(list(enumerate(layer_plan(cfg))))}
    for kind, leaf in (("attn", "attn.wq.w"), ("attn_geglu", "attn.wq.w"),
                       ("moe_attn", "moe.experts.down"), ("mla_dense", "attn.wkv_b.w"),
                       ("mla_moe", "moe.experts.down"), ("mlstm", "mix.wq.w"),
                       ("slstm", "mix.wr.w"), ("rec", "mix.w_in.w")):
        if kind in first:
            assert got[f"blocks.{first[kind]}.{leaf}"].dtype == cfg.compute_dtype, kind
            assert got[f"blocks.{first[kind]}.norm1.scale"].dtype == cfg.param_dtype, kind
    table = "embed.cb0.table" if cfg.n_codebooks > 1 else "embed.table"
    assert got[table].dtype == cfg.compute_dtype
    if cfg.mtp:
        assert got["mtp.proj.w"].dtype == cfg.compute_dtype
        assert got["mtp.block.attn.kv_norm.scale"].dtype == cfg.param_dtype
    if "blocks.0.mix.w_in.w" in got:  # an RG-LRU block: its float32 leaves stay so
        assert got["blocks.0.mix.w_in.w"].dtype == cfg.compute_dtype
        for name in ("w_a.w", "w_x.w", "conv", "lam"):
            assert got[f"blocks.0.mix.{name}"].dtype == cfg.param_dtype
    assert got["final_norm.scale"].dtype == cfg.param_dtype


@pytest.mark.parametrize("arch", PORTED)
def test_meta_structure_keeps_the_tree_order(arch):
    cfg = get_smoke_config(arch)
    meta = LM(cfg).state_dict()
    want = whole_tree_then_cast(cfg, torch.Generator().manual_seed(SEED))
    assert list(meta) == list(want)
    for name, t in meta.items():
        assert t.device.type == "meta"
        assert (t.shape, t.dtype) == (want[name].shape, want[name].dtype), name


class DrawSpy:
    """Wraps ``common._normal``: remembers each float32 draw weakly, with
    the piece it belongs to, and at every draw records which earlier
    draws are still alive.  ``piece`` is advanced by the caller."""

    def __init__(self, monkeypatch):
        self.draws = []  # (weakref, piece, bytes)
        self.piece = 0
        self.stale = []  # (piece of a live draw, piece drawing now)
        self.peak = 0  # the most float32 draw bytes alive at once
        orig = common._normal

        def spy(generator, shape, scale, dtype):
            self.check()
            t = orig(generator, shape, scale, dtype)
            if t.dtype == torch.float32:
                self.draws.append((weakref.ref(t), self.piece, t.numel() * 4))
            self.peak = max(self.peak, self.alive_bytes())
            return t

        monkeypatch.setattr(common, "_normal", spy)

    def alive(self):
        return [(piece, nbytes) for ref, piece, nbytes in self.draws if ref() is not None]

    def alive_bytes(self) -> int:
        return sum(nbytes for _, nbytes in self.alive())

    def check(self):
        self.stale += [(piece, self.piece) for piece, _ in self.alive() if piece != self.piece]

    def bytes_by_piece(self):
        out = {}
        for _, piece, nbytes in self.draws:
            out[piece] = out.get(piece, 0) + nbytes
        return out


@pytest.mark.parametrize("arch", PORTED)
def test_init_holds_at_most_one_piece_in_float32(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    model = LM(cfg)
    spy = DrawSpy(monkeypatch)
    adopt = model._adopt

    def counted(name, piece):
        adopt(name, piece)
        spy.piece += 1

    monkeypatch.setattr(model, "_adopt", counted)
    model.init(torch.Generator().manual_seed(SEED))
    by_piece = spy.bytes_by_piece()
    assert len(by_piece) >= 1 + cfg.n_layers  # the embedding and every block draw
    assert spy.stale == []
    assert spy.peak <= max(by_piece.values()) < sum(by_piece.values())
    assert spy.alive() == []  # every float32 draw is gone once init returns
    block = model.blocks[0]
    ffn = (block["moe"]["shared"] if "moe" in block else
           block["mlp"] if "mlp" in block else block["mix"])
    assert ffn["up"]["w"].dtype == cfg.compute_dtype


@pytest.mark.parametrize("arch", PORTED)
def test_the_spy_sees_the_whole_tree_algorithm_hold_every_draw(arch, monkeypatch):
    """The control: under the old algorithm every float32 draw is alive
    at the last draw, so the spy's peak is the whole tree."""
    cfg = get_smoke_config(arch)
    spy = DrawSpy(monkeypatch)
    whole_tree_then_cast(cfg, torch.Generator().manual_seed(SEED))
    assert spy.peak == sum(spy.bytes_by_piece().values())
    assert spy.alive() == []
