"""Dry-run of the port: plan every (arch × shape × mesh) cell on meta tensors.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell on 512 placeholder devices.  The port needs no
device: parameters (``LM.init_params``), optimizer state, decode caches
and batches (``configs.shapes.input_specs``) are tensors on ``meta``, the
production mesh is abstract (``launch.mesh``), and the sharding rules
(``distribution.sharding``) give every leaf its spec.  A record keeps the
JAX record's keys.

Equal to the JAX dry-run, leaf for leaf: ``param_bytes_global``,
``state_bytes_global``, ``decode_state_bytes_global``, ``optimizer`` and
``memory["argument_bytes"]`` (each argument leaf's bytes over the product
of the axis sizes its spec names).

The port's own counts, which XLA does not make the same way:

* ``flops_per_device`` and ``bytes_per_device``: the step run once on
  meta tensors, globally, then divided by the chips.  FLOPs are
  ``torch.utils.flop_counter.FlopCounterMode``'s (matmuls, convolutions
  and attention products; no elementwise work, which XLA's cost analysis
  counts).  Bytes are each aten op's input and output bytes (a view
  moves none, a copy its source twice, an indexed write its values
  twice), ops one at a time, as eager PyTorch runs them: XLA counts
  after fusion, over its partitioned program, replicated work included.
  With ``use_flash_kernel`` the attention kernels count as one op each:
  q, k, v and the output once, and the products of the pairs their mask
  keeps (decode: the whole cache; its lengths are data).
  Depth is counted as the JAX roofline counts it: one unit of each
  segment, then each segment one unit deeper, taken to the full depth
  by ``roofline.extrapolate``.  A config with a time loop (the xLSTM
  kinds: the sLSTM's S steps, the mLSTM's S/64 chunks) is counted at
  S = 64 and 128 and taken to S the same way, so no loop is unrolled.
* ``collectives``: from the specs, with the ring formulas of the JAX
  ``parse_collectives`` (:func:`wire_bytes`).  Every parameter sharded
  over a batch axis is all-gathered over those axes (twice in a train
  step: forward and backward), and a train step reduce-scatters its
  gradient over them and all-reduces it over the batch axes it is not
  sharded on.  At the activation boundaries the models mark
  (``constrain_*``, recorded by ``sharding.recording_constraints``): an
  MoE buffer with its experts over the TP axis is an all-to-all over it
  (the EP dispatch), a residual with its sequence over the TP axis an
  all-gather and a reduce-scatter over it (sequence parallelism); a
  train step doubles both for the backward.
* ``memory``: only ``argument_bytes``; nothing is compiled, so the
  temporaries, outputs and aliases are None, as are ``compile_s`` and
  ``hlo_bytes``.  ``lower_s`` is the counting's seconds.

Two figures for the port's serving: ``serve_param_bytes_global``, the
serving ``LM``'s weights (matmul weights stored in the compute dtype), and
``serve_init_peak_bytes``, the most ``LM.init`` holds at once on one
device (the weights adopted so far, plus the piece being drawn in the
param dtype and its cast copies).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --force

Results accumulate in ``results/torch_dryrun.json`` (cells are skipped
when already recorded — delete the file or pass --force to redo).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import time
import traceback
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, WorkloadShape, input_specs, shape_applicable
from repro_torch.distribution.sharding import (
    DEFAULT_RULES,
    RULE_PROFILES,
    P,
    ShardingRules,
    batch_shardings,
    mesh_shape,
    param_shardings,
    recording_constraints,
    set_activation_mesh,
    spec_axes,
    state_shardings,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import DRYRUN_PATH, extrapolate, variant_config
from repro_torch.models.lm import LM, LMConfig, layer_plan
from repro_torch.train.step import TrainStepConfig, make_train_state, make_train_step
from repro_torch.utils.tree import flatten_with_paths, tree_size_bytes, unflatten_like

RESULTS_PATH = DRYRUN_PATH

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: block kinds whose forward is a loop over time: counted at these two
#: sequence lengths (the mLSTM's chunk and twice it) and extrapolated
_TIME_LOOP_KINDS = ("mlstm", "slstm")
_SEQ_STEP = 64


def wire_bytes(op: str, result_bytes: float, n: int) -> float:
    """Ring-algorithm wire bytes a device sends for one collective, from
    its per-device result bytes R and group size N (the JAX
    ``parse_collectives``' formulas)::

      all-gather          R (N-1)/N
      all-reduce          2R (N-1)/N
      reduce-scatter      R (N-1)        (operand is R*N per device)
      all-to-all          R (N-1)/N
      collective-permute  R
    """
    if op == "collective-permute":
        return float(result_bytes)
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return result_bytes * (n - 1) / n
    if op == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return result_bytes * (n - 1)
    if op == "all-to-all":
        return result_bytes * (n - 1) / n
    raise ValueError(f"unknown collective {op!r}")


# ------------------------------------------------------------- counting
_aten = torch.ops.aten
#: ops that move no data: allocation without a write
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.lift_fresh.default}
#: in-place writes at indices: ``self`` is written where indexed only
_INDEXED_WRITES = {_aten.index_put_.default, _aten._index_put_impl_.default}


def _nbytes(x: Any) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one aten op reads and writes, counted as the module's
    docstring says."""
    if func.is_view or func in _NO_TRAFFIC:
        return 0
    if func is _aten.copy_.default:
        return 2 * _nbytes(args[1])
    if func in _INDEXED_WRITES:
        indices = sum(_nbytes(t) for t in tree_leaves(args[1]))
        return indices + 2 * _nbytes(args[2])
    return sum(_nbytes(t) for t in tree_leaves((args, kwargs, out)))


class _ByteCounter(TorchDispatchMode):
    """Sums :func:`op_bytes` and notes every tensor an op reads."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.read: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.read.update(id(t) for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
        out = func(*args, **kwargs)
        self.bytes += op_bytes(func, args, kwargs, out)
        return out


@dataclasses.dataclass
class Count:
    flops: float = 0.0
    bytes: float = 0.0
    constraints: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    #: the argument leaves the step read, as ``"params/<JAX path>"``,
    #: ``"state/<path>"`` and ``"batch/<name>"`` (XLA prunes the others
    #: from a jitted step's arguments: the MTP head and a codebook model's
    #: ``lm_head`` when serving, ``lengths`` in an xLSTM's decode)
    read: set = dataclasses.field(default_factory=set)


def _visible_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs a causal or windowed S x S mask keeps."""
    if not causal:
        return s * s
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


@contextlib.contextmanager
def _kernel_stand_ins(count: Count) -> Iterator[None]:
    """The two attention kernels as one counted op each, for the models'
    kernel route on meta tensors (the wrappers launch on the card or take
    the plain version on the CPU; the plain versions write S x S scores
    the kernels never write)."""
    import repro_torch.kernels.decode_attention as dec
    import repro_torch.kernels.flash_attention as fl

    def flash(q, k, v, *, causal=True, window=None, **_):
        b, h, s, d = q.shape
        count.flops += 4.0 * b * h * _visible_pairs(s, causal, window) * d
        count.bytes += 2 * _nbytes(q) + _nbytes(k) + _nbytes(v)
        return torch.empty_like(q)

    def decode(q, k_cache, v_cache, lengths, **_):
        b, h, d = q.shape
        count.flops += 4.0 * b * h * k_cache.shape[2] * d
        count.bytes += 2 * _nbytes(q) + _nbytes(k_cache) + _nbytes(v_cache) + _nbytes(lengths)
        return torch.empty_like(q)

    saved = fl.flash_attention, dec.decode_attention
    fl.flash_attention, dec.decode_attention = flash, decode
    try:
        yield
    finally:
        fl.flash_attention, dec.decode_attention = saved


def _train_step_cfg(arch: str) -> TrainStepConfig:
    if arch == "deepseek_v3_671b":
        # factored second moment + bf16 first moment: the only optimizer
        # state that fits 671B on 512 x 16GB
        return TrainStepConfig(optimizer="adafactor")
    return TrainStepConfig(optimizer="adamw")


def _count_step(cfg: LMConfig, shape: WorkloadShape, scfg: TrainStepConfig) -> Count:
    """One step of the cell on meta tensors, counted."""
    model = LM(cfg)
    specs = input_specs(cfg, shape)
    count = Count()
    stand_ins = _kernel_stand_ins(count) if cfg.use_flash_kernel else contextlib.nullcontext()
    with torch.no_grad():
        if shape.kind == "train":
            params = model.init_params(None)
            state = make_train_state(model, params, scfg)
            step = make_train_step(model, scfg)
        elif shape.kind == "decode":
            state = model.init_decode_state(shape.global_batch, max_len=shape.seq_len)
    if shape.kind == "train":
        args = {"params": params, "state": state}
    else:  # the serving LM's parameters, by their JAX-tree paths
        args = {"params": {_jax_path(cfg, name): p for name, p in model.named_parameters()}}
        if shape.kind == "decode":
            args["state"] = state
    args["batch"] = specs
    with recording_constraints() as records, stand_ins, \
            FlopCounterMode(display=False) as flops, _ByteCounter() as moved:
        if shape.kind == "train":
            step(params, state, specs)
        elif shape.kind == "prefill":
            model(specs["tokens"], specs.get("patch_embeds"))[:, -1]
        else:
            model.decode_step(state, specs["tokens"], specs["lengths"])
    count.flops += flops.get_total_flops()
    count.bytes += moved.bytes
    count.constraints = list(records)
    count.read = {path for path, t in flatten_with_paths(args).items() if id(t) in moved.read}
    return count


def _jax_path(cfg: LMConfig, name: str) -> str:
    """The JAX tree's path of the serving LM's parameter ``name``
    (``blocks.3.attn.wq.w`` → ``seg0/b0/attn/wq/w``)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        si, i, _, _ = layer_plan(cfg)[int(parts[1])]
        parts = [f"seg{si}", f"b{i}", *parts[2:]]
    return "/".join(parts)


def _activation_collectives(records: List[Dict[str, Any]], sizes: Dict[str, int],
                            rules: ShardingRules, train: bool) -> Dict[str, Dict[str, float]]:
    """The collectives at the recorded constraint boundaries (the module's
    docstring says which)."""
    out = {c: {"count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0} for c in _COLLECTIVES}
    tp = rules.tp_axis if rules.tp_axis in sizes else None
    times = 2 if train else 1

    def add(op, result, n):
        rec = out[op]
        rec["count"] += times
        rec["result_bytes"] += times * result
        rec["wire_bytes"] += times * wire_bytes(op, result, n)

    for r in records:
        spec = r["spec"]
        if tp is None or len(spec) < 2 or spec[1] != tp:
            continue
        shard = r["bytes"] / int(np.prod([sizes[a] for a in spec_axes(spec)]))
        n = sizes[tp]
        if r["fn"] == "moe_buffer":
            add("all-to-all", shard, n)
        elif r["fn"] == "batch":
            add("all-gather", shard * n, n)
            add("reduce-scatter", shard, n)
    return out


def _flat_count(count: Count, sizes, rules, train) -> Dict[str, float]:
    flat = {"flops": count.flops, "bytes": count.bytes}
    for op, rec in _activation_collectives(count.constraints, sizes, rules, train).items():
        for field, v in rec.items():
            flat[f"{op}/{field}"] = v
    return flat


def _count_seq(cfg: LMConfig, shape: WorkloadShape, scfg, sizes, rules):
    """One variant's counts at the cell's sequence length, and the
    argument leaves it read; a config with a time loop counted at S = 64
    and 128 and extrapolated to S."""
    train = shape.kind == "train"
    loops = any(k in _TIME_LOOP_KINDS for unit, _ in cfg.segments for k in unit)
    if not loops or shape.kind == "decode":
        count = _count_step(cfg, shape, scfg)
        return _flat_count(count, sizes, rules, train), count.read
    if shape.seq_len % _SEQ_STEP:
        raise ValueError(f"{cfg.name}: sequence {shape.seq_len} is not a multiple of "
                         f"{_SEQ_STEP}")
    var: Dict[str, Any] = {"counts": [shape.seq_len // _SEQ_STEP]}
    for name, s in (("v0", _SEQ_STEP), ("v1", 2 * _SEQ_STEP)):
        count = _count_step(cfg, dataclasses.replace(shape, seq_len=s), scfg)
        var[name] = _flat_count(count, sizes, rules, train)
    return {field: extrapolate(var, field) for field in var["v0"]}, count.read


def _count_cell(cfg: LMConfig, shape: WorkloadShape, scfg, sizes, rules):
    """The full depth's counts: one unit of each segment (v0), each
    segment one unit deeper (v_i; a segment of one unit needs none), and
    ``extrapolate``; with the argument leaves v0 read (its paths are the
    full config's: segment i is still ``seg{i}``)."""
    nseg = len(cfg.segments)
    counts = [c for _, c in cfg.segments]
    var: Dict[str, Any] = {"counts": counts}
    var["v0"], read = _count_seq(variant_config(cfg, [1] * nseg), shape, scfg, sizes, rules)
    for i in range(nseg):
        if counts[i] == 1:
            var[f"v{i + 1}"] = var["v0"]
            continue
        reps = [1] * nseg
        reps[i] = 2
        var[f"v{i + 1}"], _ = _count_seq(variant_config(cfg, reps), shape, scfg, sizes, rules)
    return {field: extrapolate(var, field) for field in var["v0"]}, read


# ------------------------------------------------------- specs and bytes
def _per_device(tree: Any, specs: Any, sizes: Dict[str, int], read: set, prefix: str) -> float:
    """Each leaf's bytes over the product of the axis sizes its spec
    names, summed over the leaves the step read."""
    flat_specs = flatten_with_paths(specs)
    total = 0.0
    for path, leaf in flatten_with_paths(tree).items():
        if f"{prefix}/{path}" in read:
            shards = int(np.prod([sizes[a] for a in spec_axes(flat_specs[path])]))
            total += _nbytes(leaf) / shards
    return total


def _param_collectives(params: Any, p_specs: Any, sizes: Dict[str, int], rules: ShardingRules,
                       batch_axes: List[str], train: bool, gather_dtype=None
                       ) -> Dict[str, Dict[str, float]]:
    """FSDP all-gathers of every leaf sharded over a batch axis (twice in a
    train step), and a train step's gradient reduce-scatters over those
    axes and all-reduces over the batch's other axes."""
    out = {c: {"count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0} for c in _COLLECTIVES}

    def add(op, result, n, times=1):
        if n <= 1:
            return
        rec = out[op]
        rec["count"] += times
        rec["result_bytes"] += times * result
        rec["wire_bytes"] += times * wire_bytes(op, result, n)

    flat_specs = flatten_with_paths(p_specs)
    for path, leaf in flatten_with_paths(params).items():
        axes = spec_axes(flat_specs[path])
        gathered = [a for a in axes if a in rules.batch_axes]
        n_sharded = int(np.prod([sizes[a] for a in axes]))
        n_gather = int(np.prod([sizes[a] for a in gathered]))
        shard = _nbytes(leaf) / n_sharded
        g_dtype = gather_dtype(leaf) if gather_dtype else leaf.dtype
        g_shard = leaf.numel() * g_dtype.itemsize / n_sharded
        add("all-gather", g_shard * n_gather, n_gather, 2 if train else 1)
        if train:
            add("reduce-scatter", shard, n_gather)
            rest = [a for a in batch_axes if a not in axes]
            add("all-reduce", shard, int(np.prod([sizes[a] for a in rest])))
    return out


def _merge(*parts: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    return {c: {f: sum(p[c][f] for p in parts) for f in ("count", "result_bytes", "wire_bytes")}
            for c in _COLLECTIVES}


def serve_init_peak_bytes(cfg: LMConfig) -> int:
    """The most device memory ``LM(cfg).init`` holds at once: for each
    piece in turn, the weights adopted before it, the piece drawn in
    ``param_dtype`` and the copies its cast makes."""
    model = LM(cfg)
    held = peak = 0
    for name, piece in model._pieces(None):
        drawn = tree_size_bytes(piece)
        model._adopt(name, piece)
        stored = list(model.get_submodule(name).parameters())
        copies = sum(_nbytes(p) for p in stored if p.dtype != cfg.param_dtype)
        peak = max(peak, held + drawn + copies)
        held += sum(_nbytes(p) for p in stored)
    return max(peak, held)


def lower_cell(
    arch: str,
    shape: WorkloadShape,
    mesh,
    *,
    rules: ShardingRules = DEFAULT_RULES,
    cfg_override: Optional[LMConfig] = None,
) -> Dict[str, Any]:
    """Plan one cell on meta tensors; return the roofline-relevant
    counts (the module's docstring says which equal the JAX dry-run's)."""
    cfg = cfg_override or get_config(arch)
    sizes = mesh_shape(mesh)
    chips = int(np.prod(list(sizes.values())))
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init_params(None)
    p_specs = param_shardings(rules, mesh, params)
    specs = input_specs(cfg, shape)
    b_specs = batch_shardings(rules, mesh, specs)
    batch_axes = spec_axes(b_specs["tokens"])
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": dict(sizes),
        "param_bytes_global": tree_size_bytes(params),
        "serve_param_bytes_global": sum(_nbytes(p) for p in model.parameters()),
    }
    scfg = _train_step_cfg(arch)
    set_activation_mesh(mesh, batch_axes=rules.batch_axes, tp_axis=rules.tp_axis,
                        seq_shard=rules.seq_shard)
    try:
        counted, read = _count_cell(cfg, shape, scfg, sizes, rules)
    finally:
        set_activation_mesh(None)

    args = (_per_device(params, p_specs, sizes, read, "params")
            + _per_device(specs, b_specs, sizes, read, "batch"))
    if shape.kind == "train":
        state = make_train_state(model, params, scfg)
        s_specs = state_shardings_like_params(rules, mesh, params, state)
        args += _per_device(state, s_specs, sizes, read, "state")
        record["optimizer"] = scfg.optimizer
        record["state_bytes_global"] = tree_size_bytes(state)

        def gather_dtype(leaf):  # the step's compute_cast
            if scfg.compute_cast is not None and leaf.dtype == torch.float32 and leaf.ndim >= 2:
                return scfg.compute_cast
            return leaf.dtype

        coll = _param_collectives(params, p_specs, sizes, rules, batch_axes, True, gather_dtype)
    else:
        record["serve_init_peak_bytes"] = serve_init_peak_bytes(cfg)
        serve = {name: p for name, p in model.named_parameters()
                 if f"params/{_jax_path(cfg, name)}" in read}
        serve_specs = param_shardings(rules, mesh, model)
        coll = _param_collectives(serve, {n: serve_specs[n] for n in serve}, sizes, rules,
                                  batch_axes, False)
        if shape.kind == "decode":
            state = model.init_decode_state(shape.global_batch, max_len=shape.seq_len)
            args += _per_device(state, state_shardings(rules, mesh, state), sizes, read, "state")
            record["decode_state_bytes_global"] = tree_size_bytes(state)
    activation = {c: {f: counted[f"{c}/{f}"] for f in ("count", "result_bytes", "wire_bytes")}
                  for c in _COLLECTIVES}
    record.update(
        {
            "ok": True,
            "lower_s": time.perf_counter() - t0,
            "compile_s": None,
            # global counts over the chips (see the module's docstring)
            "flops_per_device": counted["flops"] / chips,
            "bytes_per_device": counted["bytes"] / chips,
            "collectives": _merge(coll, activation),
            "memory": {
                "argument_bytes": args,
                "output_bytes": None,
                "temp_bytes": None,
                "alias_bytes": None,
                "generated_code_bytes": None,
            },
            "hlo_bytes": None,
            "route": "kernel" if cfg.use_flash_kernel else "reference",
        }
    )
    print(
        f"  counted: flops/device={record['flops_per_device']:.3e} "
        f"bytes/device={record['bytes_per_device']:.3e} "
        f"arguments/device={args:.3e} B"
    )
    return record


def state_shardings_like_params(rules, mesh, params, state):
    """Optimizer state: moments shard exactly like their parameters
    (ZeRO via inheritance); factored/scalar leaves replicate."""
    params_flat = flatten_with_paths(params)
    p_specs = {
        path: rules.spec_for(path, leaf.shape, mesh)
        for path, leaf in params_flat.items()
    }

    def assign(path: str, leaf):
        m = re.match(r"(?:opt/)?(?:m|v|ef)/(.*)", path)
        if not m:
            return P()  # step counters
        sub = m.group(1)
        fact = re.match(r"(.*)/(row|col|full)$", sub)
        base = fact.group(1) if fact else sub
        if base not in p_specs:
            return P()
        pshape = params_flat[base].shape
        parts = list(p_specs[base])
        parts += [None] * (len(pshape) - len(parts))
        if fact is None or fact.group(2) == "full":
            if tuple(leaf.shape) == tuple(pshape):
                return p_specs[base]
            return P()
        # adafactor factored moments: inherit the parent spec on the
        # dims they keep (row drops the last dim, col the 2nd-to-last)
        spec = parts[:-1] if fact.group(2) == "row" else parts[:-2] + [parts[-1]]
        return P(*spec)

    flat = flatten_with_paths(state)
    return unflatten_like(state, {path: assign(path, leaf) for path, leaf in flat.items()})


# --------------------------------------------------------------------- main
def load_results() -> Dict[str, Any]:
    if RESULTS_PATH.exists():
        return json.loads(RESULTS_PATH.read_text())
    return {}


def save_results(results: Dict[str, Any]) -> None:
    RESULTS_PATH.parent.mkdir(parents=True, exist_ok=True)
    RESULTS_PATH.write_text(json.dumps(results, indent=1, sort_keys=True))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES), help="one shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument(
        "--rules", default="default", choices=["default", "fsdp"],
        help="sharding profile (fsdp = no TP, batch over all axes)",
    )
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch.replace("-", "_")] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = load_results()
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            skip = shape_applicable(cfg, shape)
            for multi in meshes:
                key = f"{arch}/{shape_name}/{'multi' if multi else 'single'}"
                if skip:
                    results[key] = {"skipped": skip}
                    print(f"[skip] {key}: {skip}")
                    continue
                if args.rules != "default":
                    key = f"{key}@{args.rules}"
                if key in results and results[key].get("ok") and not args.force:
                    print(f"[cached] {key}")
                    continue
                print(f"[plan] {key} ...", flush=True)
                try:
                    rec = lower_cell(
                        arch, shape, make_production_mesh(multi_pod=multi),
                        rules=RULE_PROFILES[args.rules],
                    )
                    results[key] = rec
                    print(f"  OK in {rec['lower_s']:.1f}s")
                except Exception as e:  # record the failure, keep going
                    tb = traceback.format_exc(limit=20)
                    results[key] = {"ok": False, "error": str(e)[:2000]}
                    print(f"  FAIL {e}")
                    print(tb[-1500:])
                save_results(results)
    print("\n=== dry-run summary ===")
    done = sum(1 for v in results.values() if v.get("ok"))
    skipped = sum(1 for v in results.values() if "skipped" in v)
    failed = [(k, v) for k, v in results.items() if v.get("ok") is False]
    print(f"ok={done} skipped={skipped} failed={len(failed)}")
    for k, v in failed:
        print(f"  FAIL {k}: {v.get('error', '')[:160]}")


if __name__ == "__main__":
    main()
