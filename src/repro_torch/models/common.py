"""Shared model components: norms, projections, RoPE, MLPs, the loss.

Conventions (as the JAX package's ``models/common.py``):

* params are nested dicts of tensors (or the ``ModuleDict`` /
  ``ParameterDict`` tree :func:`as_module` makes of them, which indexes
  the same way);
* every ``init_*`` draws from a ``torch.Generator`` (one stream, drawn
  in order, where JAX splits keys) on the device the tensors go to; with
  ``generator=None`` it makes the same shapes on the ``meta`` device (no
  memory), which :class:`repro_torch.models.lm.LM` uses to build its
  structure before the weights arrive;
* computation dtype and parameter dtype are separate (bf16 compute,
  float32 params by default).

``linear`` casts both operands to the compute dtype before the product,
as the JAX package does; a weight already held in that dtype (the LM
stores its matmul weights so, see ``lm.py``) costs no cast.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]


# ----------------------------------------------------------------- inits
def device_of(generator: Optional[torch.Generator]) -> torch.device:
    """Where an init puts its tensors: the generator's device, or ``meta``."""
    return torch.device("meta") if generator is None else generator.device


def _normal(generator: Optional[torch.Generator], shape, scale: float, dtype) -> torch.Tensor:
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device)
    # scaled in place (the same float32 product as ``x * scale``): a draw
    # in float32 for a bf16 leaf then costs one float32 copy, not two
    # (deepseek-v3's expert stacks are 3.8 G elements each)
    return x.mul_(scale).to(dtype)


def init_linear(
    generator, d_in: int, d_out: int, *, dtype=torch.float32, scale: Optional[float] = None
) -> Params:
    scale = scale if scale is not None else d_in**-0.5
    return {"w": _normal(generator, (d_in, d_out), scale, dtype)}


def linear(p: Params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    return x.to(compute_dtype) @ p["w"].to(compute_dtype)


def init_embedding(generator, vocab: int, d: int, *, dtype=torch.float32) -> Params:
    # d**-0.5 keeps the TIED readout (h @ table.T) at unit-scale logits
    return {"table": _normal(generator, (vocab, d), d**-0.5, dtype)}


def embed(p: Params, ids: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    # cast, then gather, as the JAX code does: under autograd the table's
    # gradient is then accumulated in compute_dtype, as JAX accumulates it
    # (the serving LM holds the table cast already, so the cast is free)
    return p["table"].to(compute_dtype)[ids]


def init_rmsnorm(d: int, *, dtype=torch.float32, device="meta") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(dtype)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(d_head: int, *, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta**exps)


def rope_tables(
    positions: torch.Tensor,  # (S,) shared, or (B, S) per-sequence (decode)
    d_head: int,
    *,
    theta: float = 10000.0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotation angles in float32: (S, D/2) for shared
    positions, (B, 1, S, D/2) for per-sequence ones (broadcast over heads)."""
    freqs = rope_frequencies(d_head, theta=theta, device=device)  # (D/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, D/2)
    if angles.dim() == 3:  # (B, S, D/2) → broadcast over the head axis
        angles = angles[:, None]
    return torch.cos(angles), torch.sin(angles)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotates the first half of the head dim against the second half
    (``x[..., :D/2]`` with ``x[..., D/2:]``), as the JAX code does: each
    product rounded to float32, their sums rounded to x's dtype."""
    d = x.shape[-1]
    x1 = x[..., : d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_mix_table(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``rope_rotate_out``'s table from ``rope_tables``: (..., S, 2, 2, D/2),
    indexed [half of x read, half of the output written]: [[cos, sin],
    [-sin, cos]]."""
    return torch.stack([cos, sin, -sin, cos], dim=-2).unflatten(-2, (2, 2))


def rope_rotate_out(x: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """``rope_rotate``'s result bit for bit, into a fresh contiguous tensor
    of x's dtype, in three float32 passes and no autograd (``out=``): x to
    float32 in its own layout; the products p[i, j] = x_i · mix[i, j], one
    launch a half of x, each rounded to float32; then p[0, j] + p[1, j]
    rounded once.  x1·cos + x2·(-sin) is x1·cos - x2·sin exactly, and
    x1·sin + x2·cos is the same sum."""
    b, h, s, d = x.shape
    half = d // 2
    xf = x.to(torch.float32).unflatten(-1, (2, 1, half))  # (B, H, S, 2, 1, D/2)
    p = torch.empty((2, b, h, s, 2, half), dtype=torch.float32, device=x.device)
    for i in range(2):
        torch.mul(xf[..., i, :, :], mix[..., i, :, :], out=p[i])
    out = torch.empty((b, h, s, d), dtype=x.dtype, device=x.device)
    torch.add(p[0], p[1], out=out.view(b, h, s, 2, half))
    return out


def apply_rope(
    x: torch.Tensor,          # (B, H, S, D)
    positions: torch.Tensor,  # (S,) shared, or (B, S) per-sequence (decode)
    *,
    theta: float = 10000.0,
) -> torch.Tensor:
    """RoPE on x at ``positions``: ``rope_rotate`` with its ``rope_tables``."""
    return rope_rotate(x, *rope_tables(positions, x.shape[-1], theta=theta, device=x.device))


# ------------------------------------------------------------------- MLPs
def init_swiglu(generator, d: int, d_ff: int, *, dtype=torch.float32) -> Params:
    return {
        "gate": init_linear(generator, d, d_ff, dtype=dtype),
        "up": init_linear(generator, d, d_ff, dtype=dtype),
        "down": init_linear(generator, d_ff, d, dtype=dtype, scale=d_ff**-0.5),
    }


def swiglu(p: Params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    g = linear(p["gate"], x, compute_dtype=compute_dtype)
    u = linear(p["up"], x, compute_dtype=compute_dtype)
    return linear(p["down"], F.silu(g) * u, compute_dtype=compute_dtype)


def init_geglu(generator, d: int, d_ff: int, *, dtype=torch.float32) -> Params:
    return init_swiglu(generator, d, d_ff, dtype=dtype)


def geglu(p: Params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    g = linear(p["gate"], x, compute_dtype=compute_dtype)
    u = linear(p["up"], x, compute_dtype=compute_dtype)
    # jax.nn.gelu defaults to the tanh approximation
    return linear(p["down"], F.gelu(g, approximate="tanh") * u, compute_dtype=compute_dtype)


# ------------------------------------------------------------------ losses
def cross_entropy(
    logits: torch.Tensor,  # (..., V) — any leading dims
    labels: torch.Tensor,  # (...)
    *,
    mask: Optional[torch.Tensor] = None,  # (...) 1.0 = count this token
) -> torch.Tensor:
    """Mean next-token negative log-likelihood in float32: logsumexp less
    the gold logit, averaged over the positions ``mask`` keeps (at least
    one)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ------------------------------------------------------------------ readout
def logits_head(embedding: Params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Tied-embedding readout (transpose of the input table)."""
    table = embedding["table"].to(compute_dtype)
    return x.to(compute_dtype) @ table.T


# ------------------------------------------------------------------ modules
def as_module(tree: Params) -> nn.Module:
    """A nested dict of tensors as ``ModuleDict``s of ``ParameterDict``s,
    so ``p["wq"]["w"]`` indexes it as it indexes the dict.  Parameters
    take no gradient: the module is what the port serves.  Training holds
    its float32 masters as the JAX package's tree of plain tensors
    instead (``LM.init_params``, ``LM.loss``, ``repro_torch.train``)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()}
        )
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        return MixedNode(tree)
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


class MixedNode(nn.Module):
    """A node that holds both tensors and sub-trees (the RG-LRU's ``mix``:
    ``conv`` and ``lam`` beside ``w_in/w`` ...), indexed like the dict it
    was made from, its keys in the dict's order."""

    def __init__(self, tree: Params):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, as_module(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self[k]) for k in self._keys]
