"""Training launcher: ``--arch`` selects a ported architecture.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 50 \
      --smoke [--device cpu]

The corpus is synthetic (Zipf, drawn from seed 0) and written into a
token table of a lake (``--lake``, default a temporary directory);
checkpoints commit to ``--branch`` in the JAX package's format.  Without
``--device`` it runs on the card and fails without one.  Like the JAX
launcher it refuses the multimodal configs (codebooks, patches): the
token table holds one stream of text tokens.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch.catalog import Catalog
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.data.tokens import TokenDataset, write_token_table
from repro_torch.io import ObjectStore
from repro_torch.models import LM
from repro_torch.table import TableFormat
from repro_torch.train import TrainLoop, TrainLoopConfig, TrainStepConfig
from repro_torch.utils.device import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"one of {[a.replace('_', '-') for a in PORTED]}")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (required on CPU)")
    ap.add_argument("--lake", default=None, help="lake root (default: tmp)")
    ap.add_argument("--branch", default="train")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.n_codebooks > 1 or cfg.num_patches:
        raise SystemExit(
            f"{cfg.name}: the token-table trainer drives LM-token archs; "
            "multimodal frontends are stubs (examples/ runs the "
            "end-to-end LM flow)"
        )
    device = resolve_device(args.device)
    model = LM(cfg)

    store = ObjectStore(args.lake or tempfile.mkdtemp())
    catalog = Catalog(store)
    fmt = TableFormat(store)
    rng = np.random.default_rng(0)
    corpus = rng.zipf(1.4, 500_000).clip(1, cfg.vocab - 1).astype(np.int32)
    key = write_token_table(fmt, catalog, "corpus", corpus)
    ds = TokenDataset(fmt, key, batch_size=args.batch, seq_len=args.seq, seed=0)

    loop = TrainLoop(
        model, ds, catalog, branch=args.branch, device=device,
        config=TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=max(args.steps // 5, 5),
            log_every=max(args.steps // 10, 1),
            step=TrainStepConfig(
                peak_lr=3e-4, warmup_steps=max(args.steps // 10, 1),
                total_steps=args.steps,
            ),
        ),
    )
    out = loop.run()
    print(
        f"{cfg.name}: {out['steps_run']} steps, final loss "
        f"{out['final_loss']:.3f}, audit_ok={out['audit_ok']}, "
        f"{out['wall_s']:.1f}s on {device}"
    )


if __name__ == "__main__":
    main()
