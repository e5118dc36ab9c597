"""The SQL front-end — multi-table SELECT with a predictable v2 grammar.

Supported grammar (case-insensitive keywords)::

    SELECT item [, item ...]
    FROM table [[AS] alias]
    [[INNER|LEFT [OUTER]] JOIN table [[AS] alias] ON colref = colref] ...
    [WHERE condition]
    [GROUP BY colref [, colref ...]]
    [ORDER BY col [ASC|DESC] [, ...]]
    [LIMIT n]

    item      := expr [AS alias] | COUNT(*) [AS alias] | fn(expr) [AS alias]
    condition := boolean expression over AND / OR / NOT, comparisons,
                 expr [NOT] IN (lit, ...), expr [NOT] BETWEEN lo AND hi
    expr      := colref | number | string-date
               | expr (+|-|*|/) expr | (condition)
    colref    := col | qualifier.col   (qualifier = table name or alias)

Precedence, loosest to tightest: OR < AND < NOT < comparison/IN/BETWEEN
< +,- < *,/ < atom.  ``IN`` lowers to an OR of equalities and ``BETWEEN``
to ``>= AND <=``, so both reuse the engine's existing operators (and
BETWEEN's conjuncts push down to the scan layer for free).

String literals that look like ISO dates ('2019-04-01') are converted to
integer days-since-epoch, matching how the synthetic taxi dataset stores
``pickup_at`` — a pragmatic "spare part" standing in for full date types.

Exactly one statement is parsed: an optional trailing ``;`` is consumed,
and anything after it — or any token left over after the clauses above —
is a :class:`SqlError` with the offending position, never a silent
truncation.  Reserved words used as aliases are likewise reported with a
position (aggregate names stay legal as aliases: the paper's own SQL
writes ``AS count``).
"""
from __future__ import annotations

import datetime as _dt
import re
from typing import List, Optional, Tuple

from repro_torch.engine.expr import Expr, col, lit
from repro_torch.engine.query import Agg, Join, Query

_TOKEN_RE = re.compile(
    r"""
    \s*(
        '[^']*'            # string literal
      | [A-Za-z_][\w.]*    # identifier / keyword
      | \d+\.\d+ | \d+     # numbers
      | >= | <= | != | <> | = | > | <
      | [(),*+\-/;]
    )
    """,
    re.VERBOSE,
)

_KEYWORDS = {"select", "from", "where", "group", "by", "order", "limit",
             "and", "or", "not", "in", "between", "as", "asc", "desc",
             "join", "inner", "left", "outer", "on",
             "count", "sum", "min", "max", "avg"}
_AGG_KEYWORDS = {"count", "sum", "min", "max", "avg"}
_CMP = {">=": "ge", "<=": "le", "!=": "ne", "<>": "ne", "=": "eq", ">": "gt", "<": "lt"}
_IDENT_RE = re.compile(r"[A-Za-z_][\w.]*")


class SqlError(SyntaxError):
    """A SQL parse error that knows *where* it happened.

    Subclasses ``SyntaxError`` so existing ``except SyntaxError`` callers
    keep working; adds the character position and the offending fragment
    so lint findings (and humans) can point at the exact spot."""

    def __init__(self, message: str, sql: str, pos: int):
        self.sql = sql
        self.pos = pos
        lo, hi = max(0, pos - 8), min(len(sql), pos + 16)
        self.fragment = sql[lo:hi].replace("\n", " ")
        super().__init__(
            f"{message} at position {pos}: "
            f"{'...' if lo > 0 else ''}{self.fragment}"
            f"{'...' if hi < len(sql) else ''}"
        )


def find_token(sql: Optional[str], token: str) -> Optional[int]:
    """Character position of ``token`` as a whole word in ``sql``.

    The shared locator behind positioned diagnostics that point at a
    *name* rather than a parse state — :class:`RouteError` quoting the
    clause that made ``engine='kernel'`` ineligible, lineage findings
    quoting the missing column.  Qualified references (``t.zone``) match
    literally; returns None when the SQL text is unavailable or the
    token does not occur.
    """
    if not sql or not token:
        return None
    m = re.search(rf"\b{re.escape(token)}\b", sql)
    return m.start() if m else None


def _tokenize(sql: str) -> List[Tuple[str, int]]:
    """``[(token, char_position), ...]`` over the cleaned SQL text."""
    pos, out = 0, []
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            bad = pos + (len(sql[pos:]) - len(sql[pos:].lstrip()))
            raise SqlError("cannot tokenize SQL", sql, bad)
        out.append((m.group(1), m.start(1)))
        pos = m.end()
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, int]], sql: str):
        self.toks = [t for t, _ in tokens]
        self.positions = [p for _, p in tokens]
        self.sql = sql
        self.i = 0

    def pos(self) -> int:
        """Character position of the current token (end of SQL if spent)."""
        if self.i < len(self.positions):
            return self.positions[self.i]
        return len(self.sql)

    def error(self, message: str) -> SqlError:
        return SqlError(message, self.sql, self.pos())

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def peek_kw(self) -> Optional[str]:
        t = self.peek()
        return t.lower() if t and t.lower() in _KEYWORDS else None

    def peek2(self) -> Optional[str]:
        return self.toks[self.i + 1] if self.i + 1 < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise self.error("unexpected end of SQL")
        self.i += 1
        return t

    def expect_kw(self, kw: str) -> None:
        if self.peek() is None:
            raise self.error(f"expected {kw.upper()}, got end of SQL")
        if self.peek().lower() != kw:
            raise self.error(f"expected {kw.upper()}, got {self.peek()!r}")
        self.i += 1

    def accept_kw(self, kw: str) -> bool:
        if self.peek() is not None and self.peek().lower() == kw:
            self.i += 1
            return True
        return False

    def error_at_last(self, message: str) -> SqlError:
        """An error pointing at the most recently consumed token."""
        pos = self.positions[self.i - 1] if self.i > 0 else 0
        return SqlError(message, self.sql, pos)

    # -------------------------------------------------------- identifiers
    def identifier(self, what: str) -> str:
        """A plain identifier; reserved words are rejected with position."""
        t = self.peek()
        if t is None or not _IDENT_RE.fullmatch(t):
            raise self.error(f"expected {what}, got {t!r}")
        if t.lower() in _KEYWORDS and t.lower() not in _AGG_KEYWORDS:
            raise self.error(
                f"reserved word {t!r} cannot be used as {what}"
            )
        return self.next()

    def _maybe_table_alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            return self.identifier("a table alias")
        t = self.peek()
        # bare alias: FROM trips t — any non-keyword identifier
        if t is not None and _IDENT_RE.fullmatch(t) and t.lower() not in _KEYWORDS:
            return self.next()
        return None

    # ---------------------------------------------------- boolean grammar
    def parse_condition(self) -> Expr:
        node = self.parse_and()
        while self.accept_kw("or"):
            node = Expr("or", (node, self.parse_and()))
        return node

    def parse_and(self) -> Expr:
        node = self.parse_not()
        while self.accept_kw("and"):
            node = Expr("and", (node, self.parse_not()))
        return node

    def parse_not(self) -> Expr:
        if self.accept_kw("not"):
            return Expr("not", (self.parse_not(),))
        return self.parse_predicate()

    def parse_predicate(self) -> Expr:
        lhs = self.parse_expr()
        negate = False
        if (
            self.peek_kw() == "not"
            and self.peek2() is not None
            and self.peek2().lower() in ("in", "between")
        ):
            self.next()
            negate = True
        if self.accept_kw("in"):
            node = self._parse_in(lhs)
        elif self.accept_kw("between"):
            lo = self.parse_expr()
            self.expect_kw("and")
            hi = self.parse_expr()
            node = Expr("and", (Expr("ge", (lhs, lo)), Expr("le", (lhs, hi))))
        elif self.peek() in _CMP:
            op = self.next()
            node = Expr(_CMP[op], (lhs, self.parse_expr()))
        else:
            return lhs  # a bare (boolean-valued) expression
        return Expr("not", (node,)) if negate else node

    def _parse_in(self, lhs: Expr) -> Expr:
        if self.next() != "(":
            raise self.error_at_last("expected ( after IN")
        values = [self.parse_expr()]
        while self.peek() == ",":
            self.next()
            values.append(self.parse_expr())
        if self.next() != ")":
            raise self.error_at_last("expected ) closing IN list")
        node = Expr("eq", (lhs, values[0]))
        for v in values[1:]:
            node = Expr("or", (node, Expr("eq", (lhs, v))))
        return node

    # ------------------------------------------------------------- exprs
    def parse_expr(self) -> Expr:
        node = self.parse_term()
        while self.peek() in ("+", "-"):
            op = self.next()
            rhs = self.parse_term()
            node = Expr("add" if op == "+" else "sub", (node, rhs))
        return node

    def parse_term(self) -> Expr:
        node = self.parse_atom()
        while self.peek() in ("*", "/"):
            op = self.next()
            rhs = self.parse_atom()
            node = Expr("mul" if op == "*" else "div", (node, rhs))
        return node

    def parse_atom(self) -> Expr:
        t = self.next()
        if t == "(":
            # parens admit a full boolean condition — on plain arithmetic
            # content the boolean levels fall straight through to parse_expr
            e = self.parse_condition()
            if self.next() != ")":
                raise self.error_at_last("expected )")
            return e
        if t.startswith("'"):
            try:
                return lit(_string_literal_value(t[1:-1]))
            except SqlError:
                raise
            except SyntaxError as e:
                raise self.error_at_last(str(e)) from e
        if re.fullmatch(r"\d+\.\d+", t):
            return lit(float(t))
        if re.fullmatch(r"\d+", t):
            return lit(int(t))
        if _IDENT_RE.fullmatch(t):
            # agg keywords double as identifiers unless followed by "("
            # (the paper's own SQL aliases a column `AS count`)
            if t.lower() not in _KEYWORDS:
                return col(t)
            if t.lower() in _AGG_KEYWORDS and self.peek() != "(":
                return col(t)
        raise self.error_at_last(f"unexpected token {t!r} in expression")

    # ------------------------------------------------------------- joins
    def parse_join(self) -> Tuple[str, Optional[str], str, str, str]:
        """One join clause → (table, alias, left_on, right_on, how).
        Caller has already consumed the leading INNER/LEFT, if any."""
        how = "inner"
        if self.accept_kw("inner"):
            pass
        elif self.accept_kw("left"):
            self.accept_kw("outer")
            how = "left"
        self.expect_kw("join")
        table = self.identifier("a table name")
        alias = self._maybe_table_alias()
        self.expect_kw("on")
        a = self.parse_expr()
        if self.peek() != "=":
            raise self.error("JOIN ... ON supports a single equality (col = col)")
        self.next()
        b = self.parse_expr()
        if a.op != "col" or b.op != "col":
            raise self.error_at_last(
                "JOIN ... ON condition must compare two columns"
            )
        if self.peek_kw() == "and":
            raise self.error(
                "composite join conditions are not supported; move residual "
                "predicates to WHERE"
            )
        qual = alias or table
        a_ref, b_ref = a.args[0], b.args[0]
        # orient the equality: the side qualified with the joined table's
        # qualifier is right_on; unqualified sides resolve at execution
        if b_ref.split(".")[0] == qual:
            left_on, right_on = a_ref, b_ref
        elif a_ref.split(".")[0] == qual:
            left_on, right_on = b_ref, a_ref
        else:
            left_on, right_on = a_ref, b_ref
        return table, alias, left_on, right_on, how

    # ------------------------------------------------------- select items
    def parse_select_item(self) -> Tuple[str, object]:
        """Return (alias, Expr | Agg)."""
        t = self.peek()
        is_agg_call = (
            t is not None
            and t.lower() in _AGG_KEYWORDS
            and self.i + 1 < len(self.toks)
            and self.toks[self.i + 1] == "("
        )
        if is_agg_call:
            fn = self.next().lower()
            if self.next() != "(":
                raise self.error_at_last(f"expected ( after {fn}")
            if fn == "count" and self.peek() == "*":
                self.next()
                inner: Optional[Expr] = None
            else:
                inner = self.parse_expr()
            if self.next() != ")":
                raise self.error_at_last("expected )")
            alias = self._maybe_alias() or fn
            fn = {"avg": "mean"}.get(fn, fn)
            return alias, Agg(fn, inner, alias)
        e = self.parse_expr()
        # a plain column's default output name is its unqualified tail
        default = e.args[0].split(".")[-1] if e.op == "col" else "expr"
        alias = self._maybe_alias() or default
        return alias, e

    def _maybe_alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            return self.identifier("an alias")
        # bare alias (SELECT x y) is not supported to keep grammar simple
        return None


def _string_literal_value(s: str) -> float:
    """Dates → integer days since epoch; everything else must be numeric."""
    try:
        d = _dt.date.fromisoformat(s)
        return float((d - _dt.date(1970, 1, 1)).days)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError as e:
        raise SyntaxError(
            f"string literal {s!r} is neither a date nor a number; "
            "the numeric engine needs encodable literals"
        ) from e


def parse_sql(sql: str) -> Query:
    cleaned = sql.strip().rstrip(";").rstrip()
    p = _Parser(_tokenize(cleaned), cleaned)
    p.expect_kw("select")
    items: List[Tuple[str, object]] = []
    if p.peek() == "*":
        p.next()  # SELECT *: no projections; output schema = input schema
    else:
        items.append(p.parse_select_item())
        while p.peek() == ",":
            p.next()
            items.append(p.parse_select_item())
    p.expect_kw("from")
    source = p.identifier("a table name")
    source_alias = p._maybe_table_alias()

    joins: List[Join] = []
    seen_quals = {source_alias or source}
    while p.peek_kw() in ("join", "inner", "left"):
        join_pos = p.pos()
        table, alias, left_on, right_on, how = p.parse_join()
        qual = alias or table
        if qual in seen_quals:
            raise SqlError(
                f"duplicate table qualifier {qual!r}; alias one side",
                cleaned, join_pos,
            )
        seen_quals.add(qual)
        joins.append(Join(table=table, left_on=left_on, right_on=right_on,
                          how=how, alias=alias))

    q = Query(source=source, source_alias=source_alias, joins=tuple(joins))
    projections = []
    for alias, item in items:
        if isinstance(item, Agg):
            q = Query(**{**q.__dict__, "aggregates": q.aggregates + (item,)})
        else:
            projections.append((alias, item))

    if p.accept_kw("where"):
        q = q.where(p.parse_condition())

    if p.accept_kw("group"):
        p.expect_kw("by")
        keys = [p.identifier("a GROUP BY column")]
        while p.peek() == ",":
            p.next()
            keys.append(p.identifier("a GROUP BY column"))
        q = q.group_by(*keys)
        # group keys are implicitly projected; drop redundant projections
        # (the key itself, or the key aliased to its output tail)
        def _is_key_proj(a: str, e) -> bool:
            return (
                e.op == "col"
                and e.args[0] in keys
                and a in (e.args[0], e.args[0].split(".")[-1])
            )
        projections = [(a, e) for a, e in projections if not _is_key_proj(a, e)]
        if projections:
            raise p.error_at_last(
                "non-key, non-aggregate projections in GROUP BY query: "
                f"{[a for a, _ in projections]}"
            )
    elif projections:
        if q.aggregates and len(projections) != len(items):
            raise p.error_at_last(
                "mixing aggregates and plain columns needs GROUP BY"
            )
        q = Query(**{**q.__dict__, "projections": tuple(projections)})

    if p.accept_kw("order"):
        p.expect_kw("by")
        while True:
            name = p.identifier("an ORDER BY column")
            desc = False
            if p.accept_kw("desc"):
                desc = True
            elif p.accept_kw("asc"):
                desc = False
            q = q.sort(name, desc=desc)
            if p.peek() == ",":
                p.next()
                continue
            break

    if p.accept_kw("limit"):
        tok = p.next()
        if not re.fullmatch(r"\d+", tok):
            raise p.error_at_last(f"LIMIT expects an integer, got {tok!r}")
        q = q.take(int(tok))

    if p.peek() == ";":
        p.next()
        if p.peek() is not None:
            raise p.error("multiple SQL statements; parse_sql takes exactly one")
    if p.peek() is not None:
        raise p.error(f"trailing tokens after statement: {p.toks[p.i:]}")
    return Query(**{**q.__dict__, "raw_sql": cleaned})
