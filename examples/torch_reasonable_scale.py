"""Reproduce Fig. 1 (Reasonable-Scale hypothesis) as terminal output —
the PyTorch port's edition of ``examples/reasonable_scale.py``.

Left panel: CCDF of SQL query times (log-log) for three companies.
Right panel: cumulative cost share vs bytes-scanned percentile.

Pure numpy, as the JAX edition: nothing runs on a device (so it takes no
``--device``), and the output is the JAX edition's, digit for digit.  The power-law fit is this file's
own copy (the JAX edition imports it from ``benchmarks/``).

Run: python examples/torch_reasonable_scale.py
"""
import numpy as np


def _fit_alpha(samples: np.ndarray, xmin: float) -> float:
    """MLE for the continuous power-law exponent (Clauset et al.)."""
    tail = samples[samples >= xmin]
    return 1.0 + len(tail) / np.sum(np.log(tail / xmin))


def ascii_loglog_ccdf(samples_by_name, *, width=60, height=14):
    lines = []
    xs = np.logspace(-0.3, 2.5, width)
    for name, s in samples_by_name.items():
        ccdf = [(s > x).mean() for x in xs]
        lines.append((name, ccdf))
    grid = [[" "] * width for _ in range(height)]
    markers = "*+o"
    for i, (name, ccdf) in enumerate(lines):
        for xi, p in enumerate(ccdf):
            if p <= 1e-4:
                continue
            y = int((np.log10(p) + 4) / 4 * (height - 1))
            grid[height - 1 - y][xi] = markers[i % len(markers)]
    out = ["CCDF P(T > t), log-log (x: 0.5s .. 300s, y: 1e-4 .. 1)"]
    out += ["|" + "".join(r) for r in grid]
    out.append("+" + "-" * width)
    out.append("legend: " + ", ".join(f"{m}={n}" for (n, _), m in
                                      zip(samples_by_name.items(), markers)))
    return "\n".join(out)


def main() -> None:
    rng = np.random.default_rng(7)
    companies = {"startup": 2.4, "scaleup": 2.1, "public": 1.9}
    samples = {
        name: 0.5 * (1 + rng.pareto(alpha - 1, 20000))
        for name, alpha in companies.items()
    }
    print(ascii_loglog_ccdf(samples))
    for name, s in samples.items():
        print(
            f"{name}: alpha_fit={_fit_alpha(s, 0.5):.2f} "
            f"median={np.median(s):.1f}s p95={np.quantile(s, .95):.1f}s "
            f"P(>10s)={(s > 10).mean():.3f}"
        )

    # right panel: cumulative cost vs percentile (billing floors make
    # spend track query count)
    b = 1e6 * (1 + rng.pareto(1.2, 50000))
    b *= 750e6 / np.quantile(b, 0.80)
    cost = np.maximum(b, 10e9)
    order = np.argsort(b)
    csum = np.cumsum(cost[order]) / cost.sum()
    print("\ncumulative cost share by bytes-scanned percentile:")
    for pct in (50, 60, 70, 80, 90, 95, 99):
        print(f"  p{pct}: {csum[int(pct / 100 * len(csum)) - 1]:.2f}")
    print(f"  (paper: ~0.80 at p80; p80 bytes = "
          f"{np.quantile(b, .8) / 1e6:.0f} MB ≈ 750 MB)")


if __name__ == "__main__":
    main()
