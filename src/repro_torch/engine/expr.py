"""Expression DSL: the common "dialect over tuples" (paper 4.4.1).

Both front-ends — SQL text (engine/sql.py) and Python pipeline functions —
lower to these `Expr` trees, which evaluate to torch tensors over a
`Columnar`.  The physical planner additionally inspects trees to extract
pushdown-able conjuncts (``col <op> literal``) for the scan layer.

A literal evaluates to its Python scalar, never to a tensor, so type
promotion matches the JAX package's weak typing: an int32 column plus an
int literal stays int32, an int32 column compared with a float literal
compares in float32, and ``/`` of int32 columns gives float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.table.scan import Predicate

_CMP_OPS = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}


@dataclass(frozen=True)
class Expr:
    """An expression tree node."""

    op: str  # "col" | "lit" | cmp | "add"|"sub"|"mul"|"div" | "and"|"or"|"not"
    args: Tuple[Any, ...]

    # ------------------------------------------------------------- builders
    def _bin(self, op: str, other: Any) -> "Expr":
        return Expr(op, (self, _wrap(other)))

    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __eq__(self, o): return self._bin("eq", o)  # type: ignore[override]
    def __ne__(self, o): return self._bin("ne", o)  # type: ignore[override]
    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return _wrap(o)._bin("add", self)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return _wrap(o)._bin("sub", self)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return _wrap(o)._bin("mul", self)
    def __truediv__(self, o): return self._bin("div", o)
    def __and__(self, o): return self._bin("and", o)
    def __or__(self, o): return self._bin("or", o)
    def __invert__(self): return Expr("not", (self,))
    def __hash__(self):  # frozen dataclass w/ overridden __eq__ needs this
        return hash((self.op, self.args))

    # ------------------------------------------------------------ analysis
    def referenced_columns(self) -> List[str]:
        if self.op == "col":
            return [self.args[0]]
        if self.op == "lit":
            return []
        out: List[str] = []
        for a in self.args:
            out.extend(a.referenced_columns())
        return list(dict.fromkeys(out))

    def as_pushdown_conjuncts(self) -> Tuple[List[Predicate], Optional["Expr"]]:
        """Split an AND-tree into (scan-pushable predicates, residual expr).

        A conjunct is pushable when it is ``col <cmp> literal`` — the shape
        the shard min/max stats can prune on.  Everything else stays as a
        residual expression evaluated in the fused program.
        """
        conjuncts = self._flatten_and()
        pushed: List[Predicate] = []
        residual: List[Expr] = []
        for c in conjuncts:
            p = c._as_simple_predicate()
            if p is not None:
                pushed.append(p)
            else:
                residual.append(c)
        res: Optional[Expr] = None
        for r in residual:
            res = r if res is None else Expr("and", (res, r))
        return pushed, res

    def _flatten_and(self) -> List["Expr"]:
        if self.op == "and":
            out: List[Expr] = []
            for a in self.args:
                out.extend(a._flatten_and())
            return out
        return [self]

    def _as_simple_predicate(self) -> Optional[Predicate]:
        if self.op not in _CMP_OPS:
            return None
        lhs, rhs = self.args
        if lhs.op == "col" and rhs.op == "lit":
            return Predicate(lhs.args[0], _CMP_OPS[self.op], float(rhs.args[0]))
        if lhs.op == "lit" and rhs.op == "col":
            flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
            return Predicate(rhs.args[0], flipped[_CMP_OPS[self.op]], float(lhs.args[0]))
        return None

    # ----------------------------------------------------------- evaluation
    def evaluate(self, columns: Dict[str, torch.Tensor]) -> Any:
        op = self.op
        if op == "col":
            name = self.args[0]
            if name not in columns:
                raise KeyError(f"no column {name!r}; have {sorted(columns)}")
            return columns[name]
        if op == "lit":
            return self.args[0]
        vals = [a.evaluate(columns) for a in self.args]
        if op == "lt": return vals[0] < vals[1]
        if op == "le": return vals[0] <= vals[1]
        if op == "gt": return vals[0] > vals[1]
        if op == "ge": return vals[0] >= vals[1]
        if op == "eq": return vals[0] == vals[1]
        if op == "ne": return vals[0] != vals[1]
        if op == "add": return vals[0] + vals[1]
        if op == "sub": return vals[0] - vals[1]
        if op == "mul": return vals[0] * vals[1]
        if op == "div": return vals[0] / vals[1]
        if op == "and": return vals[0] & vals[1]
        if op == "or": return vals[0] | vals[1]
        if op == "not":
            return (not vals[0]) if isinstance(vals[0], bool) else ~vals[0]
        raise ValueError(f"unknown expr op {op!r}")

    def to_json_dict(self) -> Dict:
        if self.op in ("col", "lit"):
            return {"op": self.op, "value": self.args[0]}
        return {"op": self.op, "args": [a.to_json_dict() for a in self.args]}


def _wrap(v: Any) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, (int, float, bool)):
        return Expr("lit", (v,))
    raise TypeError(f"cannot lift {type(v)} into Expr")


def col(name: str) -> Expr:
    return Expr("col", (name,))


def lit(value: Any) -> Expr:
    return Expr("lit", (value,))
