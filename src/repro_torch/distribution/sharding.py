"""Sharding rules: parameter-path patterns → PartitionSpecs with fallbacks.

The port of the JAX package's ``distribution/sharding.py``, rule for rule.
Rules are ordered ``(regex, candidates)`` where each candidate is a tuple
of mesh-axis names (or None) per trailing dimension.  The first candidate
whose every named axis divides the corresponding dim is chosen; otherwise
the dim is replicated.  This fallback chain is how e.g. qwen2-moe's 60
experts (not divisible by model=16) degrade gracefully from EP to
expert-internal TP without per-arch special cases.

A *mesh* here is anything that names its axes' sizes: an abstract mesh
(``repro_torch.launch.mesh.make_production_mesh``, or any object whose
``.shape`` maps axis names to sizes) or a real
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names``).
:class:`PartitionSpec` is the port's own: one entry per tensor dim, each
an axis name, a tuple of names (one dim over several axes) or None,
equal to the tuple of its entries.  :func:`to_placements` turns one into
DTensor placements for a ``DeviceMesh``.

Paths are ``/``-joined.  The serving ``LM`` holds one module per layer
(``blocks.3.attn.wq.w`` matches as ``blocks/3/attn/wq/w``); the JAX-layout
trees of training (``LM.init_params``) stack a segment's layers on a
leading dim (``seg0/b0/attn/wq/w``) that is never sharded — the matcher
prepends None for them, so a layer's spec is its stacked leaf's spec
without that leading None.

``constrain_batch``, ``constrain_moe_buffer``, ``constrain_heads`` and
``constrain_logits`` pin activations at the JAX models' call sites.  With
no mesh registered (:func:`set_activation_mesh`) each returns its input
itself, the first thing it checks: a decode step calls them per layer.
With a mesh they choose the JAX package's spec, redistribute a ``DTensor``
to it (a plain tensor stays as it is: one device holds all of it), and
append the choice to the list :func:`recording_constraints` opened, which
is how the dry-run counts the collectives at those boundaries.
"""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_paths, unflatten_like

Axis = Optional[Union[str, Tuple[str, ...]]]
Candidate = Tuple[Axis, ...]


class PartitionSpec:
    """One entry per tensor dim: an axis name, a tuple of names, or None
    (replicated).  ``PartitionSpec()`` replicates every dim.  As JAX's, it
    reads a tuple of one name as the name and an empty tuple as None, and
    refuses an axis named twice (a ``ValueError``; JAX's ``NamedSharding``
    raises ``DuplicateSpecError``, which the JAX ``state_shardings`` meets
    under the fsdp profile at decode: the sequence and the heads both
    over "model").  It iterates and indexes as the tuple of its entries
    and equals that tuple; it is not a tuple itself, so a tree of specs
    keeps them as leaves."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Axis) -> None:
        def canonical(part: Axis) -> Axis:
            if isinstance(part, tuple) and len(part) <= 1:
                return part[0] if part else None
            return part

        self.parts: Tuple[Axis, ...] = tuple(canonical(p) for p in parts)
        axes = spec_axes(self.parts)
        if len(set(axes)) != len(axes):  # as JAX's NamedSharding refuses it
            raise ValueError(f"{self!r} has duplicate entries for "
                             f"{sorted({a for a in axes if axes.count(a) > 1})}")

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


P = PartitionSpec


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """Axis sizes by name, of a ``DeviceMesh`` or of anything whose
    ``.shape`` maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def spec_axes(spec: Sequence[Axis]) -> List[str]:
    """Every axis name ``spec`` shards over, in order."""
    out: List[str] = []
    for part in spec:
        if part is not None:
            out.extend(part if isinstance(part, tuple) else (part,))
    return out


#: ("data",) means FSDP over the data axis; ("model",) is tensor parallel.
#: Multi-axis entries like ("data", "model") shard one dim over both.
@dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, Tuple[Candidate, ...]], ...]
    #: batch axes for activations/inputs
    batch_axes: Tuple[str, ...] = ("pod", "data")
    #: axis to shard long sequences over when batch is unshardable
    seq_axis: str = "data"
    #: tensor-parallel axis for activation constraints (None = no TP)
    tp_axis: Optional[str] = "model"
    #: Megatron-style sequence sharding of residual activations
    seq_shard: bool = True
    name: str = "default"

    def spec_for(self, path: str, shape: Sequence[int], mesh: Any) -> PartitionSpec:
        sizes = mesh_shape(mesh)
        trailing = list(shape)
        if re.search(r"(^|/)seg\d+/", path):  # stacked layer dim: unsharded
            trailing = trailing[1:]
        for pattern, candidates in self.rules:
            if re.search(pattern, path):
                chosen = _first_fitting(candidates, trailing, sizes)
                if chosen is None:
                    chosen = (None,) * len(trailing)
                if len(trailing) != len(shape):
                    chosen = (None,) + tuple(chosen)
                return P(*chosen)
        return P()  # replicate by default (norms, scalars)


def _axis_size(sizes: Mapping[str, int], axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([sizes[a] for a in axis]))
    return sizes[axis]


def _first_fitting(
    candidates: Tuple[Candidate, ...], shape: Sequence[int], sizes: Mapping[str, int]
) -> Optional[Candidate]:
    for cand in candidates:
        if len(cand) != len(shape):
            continue
        ok = True
        for dim, axis in zip(shape, cand):
            if axis is None:
                continue
            size = _axis_size(sizes, axis)
            if size == 0 or dim % size != 0:
                ok = False
                break
            # axis must exist in this mesh
            names = axis if isinstance(axis, tuple) else (axis,)
            if any(a not in sizes for a in names):
                ok = False
                break
        if ok:
            return cand
    return None


DEFAULT_RULES = ShardingRules(
    rules=(
        # --- embeddings / output heads: vocab over model (Megatron-style),
        #     embed dim over data (FSDP); fall back to data-only.
        (r"embed(/cb\d+)?/table", ((("model"), ("data")), (None, ("data")), (None, None))),
        (r"(lm_head|heads/cb\d+)/w", ((("data"), ("model")), (None, ("model")), (None, None))),
        # --- MoE experts: EP first (experts over model), else expert TP
        (r"moe/experts/(gate|up)", (
            (("model"), ("data"), None),      # EP + FSDP on d_in
            (None, ("data"), ("model")),      # expert-internal TP on d_ff
            (None, None, ("model")),
            (None, None, None),
        )),
        (r"moe/experts/down", (
            (("model"), None, ("data")),
            (None, ("model"), ("data")),
            (None, ("model"), None),
            (None, None, None),
        )),
        (r"moe/router/w", ((("data"), None), (None, None))),
        (r"moe/shared/(gate|up)/w", ((("data"), ("model")), (None, ("model")), (None, None))),
        (r"moe/shared/down/w", ((("model"), ("data")), (("model"), None), (None, None))),
        # --- attention: column-parallel qkv, row-parallel out
        (r"attn/w(q|k|v)(_b)?/w", ((("data"), ("model")), (None, ("model")), (None, None))),
        (r"attn/wo/w", ((("model"), ("data")), (("model"), None), (None, None))),
        (r"attn/w(q|kv)_a/w", ((("data"), None), (None, None))),
        # --- dense MLPs: column then row
        (r"mlp/(gate|up)/w", ((("data"), ("model")), (None, ("model")), (None, None))),
        (r"mlp/down/w", ((("model"), ("data")), (("model"), None), (None, None))),
        # --- recurrent blocks: inner dim over model where divisible
        (r"mix/(up|wq|wk|wv|w_in|w_gate|up_gate)/w", ((("data"), ("model")), (None, ("model")), (None, None))),
        (r"mix/(down|w_out)/w", ((("model"), ("data")), (("model"), None), (None, None))),
        (r"mix/(wi|wf|wx|wr|w_a|w_x)/w", ((("data"), None), (None, None))),
        (r"mtp/proj/w", ((("data"), ("model")), (None, None))),
    ),
)


#: Pure-FSDP profile (collective-bound dense training): batch shards over
#: EVERY mesh axis, parameters fully shard over (data, model) with no
#: tensor parallelism — per-step collectives are O(param bytes)
#: all-gathers + grad reduce-scatters instead of O(activations × layers)
#: TP reductions.  MoE archs keep DEFAULT_RULES (experts must stay
#: distributed); this profile suits dense ≤ ~40B.
FSDP_RULES = ShardingRules(
    rules=(
        (
            r"",  # every parameter: fully shard, fall back gracefully
            (
                ("data", "model"),
                ("data", None),
                (None, "model"),
                (None, None),
                ("data", "model", None),
                (None, "data", "model"),
                (None, None, None),
                (None,),
            ),
        ),
    ),
    batch_axes=("pod", "data", "model"),
    seq_axis="model",
    tp_axis=None,
    seq_shard=False,
    name="fsdp",
)

RULE_PROFILES = {"default": DEFAULT_RULES, "fsdp": FSDP_RULES}


# ------------------------------------------------------------------ helpers
def _map_with_paths(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over a tree's leaves, keeping its structure."""
    flat = flatten_with_paths(tree)
    return unflatten_like(tree, {path: fn(path, leaf) for path, leaf in flat.items()})


def param_shardings(rules: ShardingRules, mesh: Any, params: Any) -> Any:
    """The spec of every parameter.  ``params`` is a module (the serving
    ``LM``: ``{"blocks.3.attn.wq.w": spec}``, by ``named_parameters``) or
    a tree of tensors (``LM.init_params``: the same structure with spec
    leaves)."""
    if isinstance(params, torch.nn.Module):
        return {name: rules.spec_for(name.replace(".", "/"), p.shape, mesh)
                for name, p in params.named_parameters()}
    return _map_with_paths(lambda path, leaf: rules.spec_for(path, leaf.shape, mesh), params)


def batch_shardings(rules: ShardingRules, mesh: Any, batch: Any) -> Any:
    """Inputs: batch dim over batch_axes (falls back to replication for
    unshardable batch=1 long-context cells)."""
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in rules.batch_axes if a in sizes)

    def assign(path: str, leaf: Any) -> PartitionSpec:
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return P()
        b = leaf.shape[0]
        size = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if size > 1 and b % size == 0:
            return P(axes, *([None] * (len(leaf.shape) - 1)))
        return P()

    return _map_with_paths(assign, batch)


def state_shardings(rules: ShardingRules, mesh: Any, state: Any) -> Any:
    """Decode caches: (layers, B, heads, S, D)-style leaves.

    Batch over batch_axes when divisible; otherwise shard the *sequence*
    axis (dim -2 for attention caches) over seq_axis — sequence-parallel
    serving for the batch=1 long-context cells.  The "model" axis shards
    the heads dim when it divides.
    """
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in rules.batch_axes if a in sizes)
    batch_size = int(np.prod([sizes[a] for a in axes])) if axes else 1
    model_size = sizes.get("model", 1)
    seq_ok = rules.seq_axis in sizes

    def assign(path: str, leaf: Any) -> PartitionSpec:
        shape = leaf.shape
        if len(shape) < 2:
            return P()
        spec: List[Any] = [None] * len(shape)
        # leading dim is the stacked-layer dim for seg* state
        bdim = 1 if re.search(r"(^|/)seg\d+/", path) else 0
        if bdim < len(shape) and shape[bdim] % max(batch_size, 1) == 0 and batch_size > 1:
            spec[bdim] = axes
        elif len(shape) >= 4 and seq_ok and shape[-2] % sizes[rules.seq_axis] == 0:
            spec[-2] = rules.seq_axis  # sequence-parallel cache (batch=1)
        # 5-D kv caches (L,B,H,S,D): heads over model when divisible,
        # otherwise shard the SEQUENCE dim over model
        if len(shape) == 5 and model_size > 1:
            if shape[2] % model_size == 0:
                spec[2] = "model"
            elif spec[3] is None and shape[3] % model_size == 0:
                spec[3] = "model"
        # 4-D latent caches (L,B,S,dkv): sequence over model
        if (
            len(shape) == 4
            and bdim == 1
            and model_size > 1
            and spec[2] is None
            and shape[2] % model_size == 0
        ):
            spec[2] = "model"
        if len(shape) == 4 and bdim == 0 and model_size > 1 and shape[1] % model_size == 0:
            spec[1] = "model"
        return P(*spec)

    return _map_with_paths(assign, state)


def to_placements(spec: Sequence[Axis], device_mesh: Any) -> List[Any]:
    """DTensor placements for ``spec`` on ``device_mesh``: one per mesh
    dim, in ``mesh_dim_names`` order, ``Shard(d)`` where tensor dim ``d``
    names that axis and ``Replicate()`` elsewhere.  A dim over several
    axes is split by them in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: Dict[str, int] = {}
    for d, part in enumerate(spec):
        for axis in spec_axes((part,)):
            dim_of[axis] = d
    unknown = set(dim_of) - set(device_mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} not in the mesh "
                         f"{device_mesh.mesh_dim_names}")
    return [Shard(dim_of[name]) if name in dim_of else Replicate()
            for name in device_mesh.mesh_dim_names]


def constrain(x: torch.Tensor, spec: Sequence[Axis]) -> torch.Tensor:
    """A ``DTensor`` redistributed to ``spec`` on its own mesh; anything
    else (a tensor one device holds whole) as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))
    return x


# ---------------------------------------------------------------------------
# Activation-constraint context.
#
# FSDP shards parameters' non-TP dim over "data" while activations shard
# their *batch* dim over the same axis.  The models call
# ``constrain_batch``/``constrain_logits`` at block boundaries; with a mesh
# registered here those pin activations to batch-over-data (the ZeRO
# dataflow).  No mesh registered (one device) → the input itself.
_ACT_MESH: Optional[Any] = None
_ACT_SIZES: Dict[str, int] = {}
_ACT_BATCH_AXES: Tuple[str, ...] = ()
_ACT_TP_AXIS: Optional[str] = None
_ACT_SEQ_SHARD: bool = False
#: the list :func:`recording_constraints` opened, or None
_RECORDS: Optional[List[Dict[str, Any]]] = None


def set_activation_mesh(
    mesh: Optional[Any],
    *,
    batch_axes: Tuple[str, ...] = ("pod", "data"),
    tp_axis: Optional[str] = "model",
    seq_shard: bool = True,
) -> None:
    """Register the mesh for activation constraints (None: no mesh).

    ``seq_shard=True`` additionally shards the *sequence* dim of
    residual-stream activations over the TP axis (Megatron sequence
    parallelism).
    """
    global _ACT_MESH, _ACT_SIZES, _ACT_BATCH_AXES, _ACT_TP_AXIS, _ACT_SEQ_SHARD
    _ACT_MESH = mesh
    _ACT_SEQ_SHARD = seq_shard
    if mesh is not None:
        _ACT_SIZES = mesh_shape(mesh)
        _ACT_BATCH_AXES = tuple(a for a in batch_axes if a in _ACT_SIZES)
        _ACT_TP_AXIS = tp_axis if (tp_axis and tp_axis in _ACT_SIZES) else None
    else:
        _ACT_SIZES = {}
        _ACT_BATCH_AXES = ()
        _ACT_TP_AXIS = None


@contextlib.contextmanager
def recording_constraints() -> Iterator[List[Dict[str, Any]]]:
    """Collect every constraint applied inside the block: ``{"fn",
    "spec", "shape", "bytes"}`` each, in call order."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def _apply(fn: str, x: torch.Tensor, parts: List[Axis]) -> torch.Tensor:
    spec = P(*parts)
    if _RECORDS is not None:
        _RECORDS.append({"fn": fn, "spec": spec, "shape": tuple(x.shape),
                         "bytes": x.numel() * x.element_size()})
    return constrain(x, spec)


def _batch_spec_for(x: torch.Tensor) -> Optional[PartitionSpec]:
    if _ACT_MESH is None or not _ACT_BATCH_AXES:
        return None
    size = int(np.prod([_ACT_SIZES[a] for a in _ACT_BATCH_AXES]))
    if x.ndim == 0 or x.shape[0] % size != 0 or size == 1:
        return None
    return P(_ACT_BATCH_AXES, *([None] * (x.ndim - 1)))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim0 (batch) to the data axes; optionally dim1 (sequence) to
    the TP axis (sequence parallelism) for 3-D residual activations."""
    if _ACT_MESH is None:
        return x
    spec = _batch_spec_for(x)
    if spec is None:
        return x
    parts = list(spec)
    if (
        _ACT_SEQ_SHARD
        and _ACT_TP_AXIS is not None
        and x.ndim == 3
        and x.shape[1] % _ACT_SIZES[_ACT_TP_AXIS] == 0
    ):
        parts[1] = _ACT_TP_AXIS
    return _apply("batch", x, parts)


def constrain_moe_buffer(x: torch.Tensor) -> torch.Tensor:
    """MoE expert tensors (B, E, C[, d]): batch over data, experts over
    the TP axis (expert parallelism) — the all-to-all boundary.  Works for
    both the routing table (3-D) and the expert input/output buffers
    (4-D)."""
    if _ACT_MESH is None:
        return x
    spec = _batch_spec_for(x)
    parts = list(spec) if spec is not None else [None] * x.ndim
    if (
        _ACT_TP_AXIS is not None
        and x.ndim in (3, 4)
        and x.shape[1] % _ACT_SIZES[_ACT_TP_AXIS] == 0
    ):
        parts[1] = _ACT_TP_AXIS
    if all(p is None for p in parts):
        return x
    return _apply("moe_buffer", x, parts)


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """Attention tensors (B, H, S, D): batch over data, heads over the TP
    axis when the head count divides it (q always; kv only for MHA-kv)."""
    if _ACT_MESH is None or x.ndim != 4:
        return x
    spec = _batch_spec_for(x)
    parts = list(spec) if spec is not None else [None] * x.ndim
    if (
        _ACT_TP_AXIS is not None
        and x.shape[1] % _ACT_SIZES[_ACT_TP_AXIS] == 0
    ):
        parts[1] = _ACT_TP_AXIS
    if all(p is None for p in parts):
        return x
    return _apply("heads", x, parts)


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    """Logits: batch over data axes, vocab (last dim) over the TP axis."""
    if _ACT_MESH is None:
        return x
    spec = _batch_spec_for(x)
    parts = list(spec) if spec is not None else [None] * x.ndim
    if (
        _ACT_TP_AXIS is not None
        and x.shape[-1] % _ACT_SIZES[_ACT_TP_AXIS] == 0
    ):
        parts[-1] = _ACT_TP_AXIS
    if all(p is None for p in parts):
        return x
    return _apply("logits", x, parts)
