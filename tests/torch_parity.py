"""Helpers for the parity tests of the SDK (``tests/test_torch_{client,
cli,maintenance,analysis,tracing}.py``) and of training
(``tests/test_torch_{train,checkpoint,train_loop}.py``).

For the SDK: one namespace per package, so a
scenario written once runs against the JAX package (``repro``, on the
CPU) and the port (``repro_torch``, ``device="cpu"``) on lakes of their
own, and the two results are compared.

Pipeline files are user code in each package's own tensors.  A file is
written once per package from one template whose only difference is the
import line (``import repro`` or ``import repro_torch as repro``), into a
directory of its own: the two packages name a discovered module after
its resolved path, so loading one path under both in one process would
let the second load replace the first's module object.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import re
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

_SUBMODULES = (
    "analysis", "analysis.catalog", "api", "api.project", "catalog",
    "catalog.nessie", "cli", "core", "core.logical", "core.physical",
    "core.runner", "core.snapshot", "engine.route", "engine.sql",
    "examples_data", "io", "maintenance", "runtime", "table", "table.scan",
    "telemetry",
)


class Pkg:
    """One package's public surface, and the device its entry points take."""

    def __init__(self, name: str):
        self.name = name
        self.port = name == "repro_torch"
        self.root = importlib.import_module(name)
        for sub in _SUBMODULES:
            mod = importlib.import_module(f"{name}.{sub}")
            attr = "cli_module" if sub == "cli" else sub.replace(".", "_")
            setattr(self, attr, mod)
        ed = self.examples_data
        self.TAXI_SCHEMA = ed.TAXI_SCHEMA
        self.make_taxi_data = ed.make_taxi_data
        self.build_taxi_pipeline = ed.build_taxi_pipeline
        self.RunState = self.api.RunState
        self.Pipeline = self.core.Pipeline
        self.ExecutorConfig = self.runtime.ExecutorConfig

    def __repr__(self) -> str:
        return self.name

    @property
    def device_kw(self) -> dict:
        return {"device": "cpu"} if self.port else {}

    def Client(self, path=None, **kw):
        return self.api.Client(path, **self.device_kw, **kw)

    def ephemeral(self, **kw):
        return self.api.Client.ephemeral(**self.device_kw, **kw)

    def Runner(self, catalog, fmt, executor=None, **kw):
        return self.core.Runner(catalog, fmt, executor, **self.device_kw, **kw)

    def cli(self, *argv):
        """``python -m <pkg>.cli`` in process: (exit code, stdout)."""
        lead = ["--device", "cpu"] if self.port else []
        buf = io.StringIO()
        code = 0
        with contextlib.redirect_stdout(buf):
            try:
                self.cli_module.main(lead + [str(a) for a in argv])
            except SystemExit as e:
                code = e.code if e.code is not None else 0
        return code, buf.getvalue()

    def write_pipeline(self, directory: Path, filename: str, body: str) -> Path:
        """``body`` (written against ``repro``) as this package's file."""
        directory = Path(directory) / self.name
        directory.mkdir(parents=True, exist_ok=True)
        head = "import repro\n" if not self.port else "import repro_torch as repro\n"
        path = directory / filename
        path.write_text(head + body)
        return path

    def seed_taxi(self, client, n=2000, *, seed=0, **kw):
        data = self.make_taxi_data(n, np.random.default_rng(seed), **kw)
        client.write_table("taxi_table", data, schema=self.TAXI_SCHEMA)
        return data


JAX = Pkg("repro")
PORT = Pkg("repro_torch")
BOTH = (JAX, PORT)


def both(scenario, tmp_path, *args, **kw):
    """``scenario(pkg, tmp_path / pkg.name, ...)`` for each package."""
    out = []
    for pkg in BOTH:
        path = Path(tmp_path) / pkg.name
        path.mkdir(parents=True, exist_ok=True)
        out.append(scenario(pkg, path, *args, **kw))
    return tuple(out)


def parity(scenario, tmp_path, *args, **kw):
    """Run ``scenario`` on both packages; the results must be equal.
    Returns the port's result."""
    j, t = both(scenario, tmp_path, *args, **kw)
    assert t == j
    return t


def handle_summary(h) -> dict:
    """What a run handle says that must not depend on the package."""
    return {
        "state": str(h.state),
        "artifacts": dict(sorted(h.artifacts.items())),
        "checks": dict(h.checks),
        "merged": h.merged_commit is not None,
        "cache": dict(h.stats.get("cache", {})),
        "stages": h.stats.get("stages"),
        # commit ids hash wall-clock timestamps: masked in messages
        "error": None if h.error is None else (
            type(h.error).__name__, _HEX.sub("<id>", str(h.error))),
    }


def read_artifacts(client, h) -> dict:
    """Every artifact of a handle read back, as lists (compared exactly)."""
    return {
        name: {c: (str(v.dtype), np.asarray(v).tolist()) for c, v in h.artifact(name).items()}
        for name in sorted(h.artifacts)
    }


def table_contents(client, branch="main") -> dict:
    """branch table -> manifest key (content addressed: equal content,
    equal key)."""
    return dict(sorted(client.tables(branch).items()))


_SECONDS = re.compile(r"\d+\.\d+(?:e-?\d+)?\s*(?:ms|s)\b|\d+\.\d+ms|\d+\.\d+s")
_HEX = re.compile(r"\b[0-9a-f]{12,}\b")
_CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")


def mask_seconds(text: str) -> str:
    """CLI output with times masked (they are the only numbers that may
    differ between two runs of the same work)."""
    return _CLOCK.sub("HH:MM:SS", _SECONDS.sub("<t>", text))


def mask_commits(text: str) -> str:
    """Commit ids hash wall-clock timestamps: mask hex ids too."""
    return _HEX.sub("<id>", mask_seconds(text))


def fanout_pipeline(pkg, threshold=10.0, *, name="telemetry_parity", width=2,
                    dropoff=False, combine=True):
    """source -> (m0 .. m{width-1}) -> combine, plus an audit: the
    reference tests' fan-out DAG, its Python nodes written in each
    package's own tensors (``jax.numpy`` or torch)."""
    p = pkg.Pipeline(name)
    extra = ", dropoff_location_id" if dropoff else ""
    p.sql(
        "trips",
        "SELECT pickup_location_id, passenger_count as count" + extra +
        " FROM taxi_table WHERE pickup_at >= '2019-04-01'",
    )

    def trips_expectation(ctx, trips):
        return trips.mean("count") > threshold

    p.python(trips_expectation)
    for i in range(width):
        p.python(_model(pkg, i))
    if combine:
        p.python(_combine(pkg))
    return p


def _model(pkg, i):
    if pkg.port:
        def fn(ctx, trips):
            col = trips.column("count").to(torch.float32)
            return {"stat": torch.sort(col).values * (i + 1)}
    else:
        def fn(ctx, trips):
            import jax.numpy as jnp

            col = trips.column("count").astype(jnp.float32)
            return {"stat": jnp.sort(col) * (i + 1)}
    fn.__name__ = f"m{i}"
    return fn


def _combine(pkg):
    def combine(ctx, m0, m1):
        return {"delta": m1.column("stat") - m0.column("stat")}
    return combine


def widths_pipeline(pkg, width=4):
    """``trips`` -> ``w0 .. w{width-1}``: the scheduler tests' fan-out."""
    p = pkg.Pipeline("sched_v2")
    p.sql("trips", "SELECT passenger_count as count FROM taxi_table")
    for i in range(width):
        p.python(_widener(pkg, i))
    return p


def _widener(pkg, i):
    if pkg.port:
        def fn(ctx, trips):
            return {"stat": trips.column("count").to(torch.float32) + i}
    else:
        def fn(ctx, trips):
            import jax.numpy as jnp

            return {"stat": trips.column("count").astype(jnp.float32) + i}
    fn.__name__ = f"w{i}"
    return fn


# ----------------------------------------------------------------- training
#: float32 in both packages: sums in other orders, a few ulps of the
#: largest compared value
F32 = 1e-5


def to_torch(tree):
    """A tree of numpy arrays (a JAX tree after ``to_numpy``) as CPU tensors."""
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def to_numpy(tree):
    """A JAX tree's leaves as numpy arrays."""
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def assert_mostly_close(got, want, *, rtol, atol, bound, key):
    """Within ``rtol``/``atol`` everywhere but on at most 0.1% of the
    elements, and each of those within ``bound``.

    After steps on each package's own gradients, a few elements turn on a
    last-place difference upstream, and each rule below bounds how far
    that can carry: a gradient within float32 rounding of 0 (|g| about
    1e-9), whose AdamW step ``g / (|g| + 1e-8)`` is a different fraction
    of +-lr, or the opposite sign, in each package (at most 2 lr a step);
    a value on a rounding tie of the int8 compression (one quantum); a
    bf16 rounding of Adafactor's ``m`` the other way."""
    diff = np.abs(got - want)
    loose = diff > atol + rtol * np.abs(want)
    assert loose.sum() <= max(1, 1e-3 * got.size), (key, int(loose.sum()), got.size)
    assert diff.max() <= bound, (key, diff.max(), bound)
