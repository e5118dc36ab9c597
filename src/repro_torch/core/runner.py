"""The run orchestrator — slice 1: the interactive query path.

``bauplan query -q "SELECT ..."`` semantics (paper 4.6): resolve every
table of the statement against the catalog at query time, plan pushdown
and the engine route from shard statistics, scan the surviving shards on
the host, move the columns to the device, and execute on the fused CUDA
kernel or the reference torch operators.  ``Runner.run`` (transform →
audit → write over ephemeral branches) arrives with the pipeline slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from dataclasses import replace as _replace
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.catalog.nessie import Catalog
from repro_torch.core.physical import plan_interactive_query, resolve_query_snapshots
from repro_torch.engine.columnar import Columnar
from repro_torch.engine.exec import compile_query
from repro_torch.engine.sql import parse_sql
from repro_torch.table.format import TableFormat
from repro_torch.table.scan import KERNEL_CHUNK_ROWS, execute_scan
from repro_torch.telemetry.bus import EventBus
from repro_torch.telemetry.events import Event, QueryExecuted
from repro_torch.utils.device import DeviceLike, resolve_device


def _check_query_columns(query, snapshots, text: str) -> None:
    """Zero-registration column validation for the interactive path.

    Every referenced column must exist in the table(s) it can refer to:
    ``qual.col`` against its owner's schema, plain names against the
    union of all resolved tables.  Failures surface as
    :class:`repro_torch.engine.sql.SqlError` carrying the offending position,
    mirroring what logical-plan validation does for pipelines.
    """
    import re as _re

    from repro_torch.engine.sql import SqlError

    def pos_of(name: str) -> int:
        m = _re.search(rf"\b{_re.escape(name)}\b", text)
        return m.start() if m else 0

    qual_tables = dict(query.qualifiers())
    union = set()
    for snap in snapshots.values():
        union |= set(snap.schema.names)
    for ref in query.referenced_columns():
        if "." in ref:
            qual, _, col = ref.partition(".")
            table = qual_tables.get(qual)
            if table is None or table not in snapshots:
                raise SqlError(
                    f"unknown table qualifier {qual!r}", text, pos_of(ref)
                )
            if not snapshots[table].schema.has(col):
                raise SqlError(
                    f"table {table!r} has no column {col!r}", text, pos_of(ref)
                )
        elif ref not in union:
            raise SqlError(f"unknown column {ref!r}", text, pos_of(ref))



@dataclass
class Runner:
    catalog: Catalog
    fmt: TableFormat
    #: anything with an ``io_pool`` (a ``concurrent.futures.Executor``)
    #: that parallelizes shard reads; None scans serially, which gives
    #: byte-identical results (``execute_scan``'s contract)
    executor: Any = None
    #: telemetry event bus (None = telemetry off: no events)
    bus: Optional[EventBus] = None
    #: where queries execute; None means ``cuda`` and raises without a
    #: CUDA device (pass ``"cpu"`` to run on the CPU)
    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def _publish(self, event: Event) -> None:
        if self.bus is not None:
            self.bus.publish(event)

    # ------------------------------------------------------------ queries
    def query(
        self,
        sql: str,
        *,
        branch: Optional[str] = None,
        commit_id: Optional[str] = None,
        engine: str = "auto",
    ) -> Dict[str, np.ndarray]:
        """``bauplan query -q "SELECT ..." [-b branch]`` — synchronous QW.

        Point-wise interactive path, zero registration: every table name
        in the statement (FROM + JOINs) resolves against the catalog at
        query time — lake tables and materialized pipeline outputs alike
        — and unknown tables/columns come back as :class:`SqlError` with
        the offending position.  Each table scans on the host in
        kernel-sized chunks and moves to the runner's device; ``engine``
        picks the filter+agg execution path ("auto" | "kernel" | "jnp", see
        engine/route.py).  Time travel via branch/commit.
        """
        t0 = time.perf_counter()
        query = parse_sql(sql)
        text = query.raw_sql or sql
        parse_s = time.perf_counter() - t0

        # -- zero-registration name resolution + planning ----------------
        t1 = time.perf_counter()
        snapshots = resolve_query_snapshots(
            self.catalog, self.fmt, query,
            branch=branch, commit_id=commit_id, text=text,
        )
        _check_query_columns(query, snapshots, text)
        iq = plan_interactive_query(query, snapshots, engine=engine)
        route, residual, scans = iq.route, iq.residual, iq.scans
        plan_s = time.perf_counter() - t1

        # -- host scans in kernel-sized chunks, then one copy each -------
        # (tables scan one after another; each scan parallelizes its own
        # shards on the io pool when there is one)
        t2 = time.perf_counter()
        pool = self.executor.io_pool if self.executor is not None else None
        rels = {
            table: Columnar.from_numpy(
                execute_scan(
                    self.fmt, scan, pool=pool,
                    bus=self.bus, tags={"source": "query", "table": table},
                    chunk_rows=KERNEL_CHUNK_ROWS,
                ),
                device=self.device,
            )
            for table, scan in scans.items()
        }
        scan_s = time.perf_counter() - t2

        # -- one executable (reference or fused-kernel path) --------------
        t3 = time.perf_counter()
        residual_query = _replace(query, filter_expr=residual)
        joined = {j.table: rels[j.table] for j in query.joins}
        out = compile_query(residual_query, route=route)(
            rels[query.source], joined or None
        )
        result = out.to_numpy()  # the device-to-host copy synchronizes
        exec_s = time.perf_counter() - t3

        rows_out = len(next(iter(result.values()))) if result else 0
        self._publish(QueryExecuted(
            table=query.source,
            rows_out=rows_out,
            shards_read=sum(len(s.shards) for s in scans.values()),
            wall_s=time.perf_counter() - t0,
            engine_path=route.engine_path,
            parse_s=parse_s,
            plan_s=plan_s,
            scan_s=scan_s,
            exec_s=exec_s,
        ))
        return result
