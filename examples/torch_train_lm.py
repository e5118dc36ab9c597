"""End to end on the PyTorch port: train a ~100M-parameter LM
through the lakehouse.

The edition of ``examples/train_lm.py`` for ``repro_torch``:

* tokens live in a versioned TensorTable (data commit pinned);
* checkpoints commit to a catalog branch (async, atomic), in the JAX
  package's format;
* the run is killed halfway and RESUMED to demonstrate restart-exactness;
* the audited final checkpoint is promoted to main (transform-audit-write).

The step runs on the card (``--device cpu``: the CPU), through the
reference attention: training reaches no kernel, in either package.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--tiny] [--device cpu]
"""
import argparse
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.catalog import Catalog
from repro_torch.data.tokens import TokenDataset, write_token_table
from repro_torch.io import ObjectStore
from repro_torch.models import LM
from repro_torch.models.lm import LMConfig, ModelFamily
from repro_torch.table import TableFormat
from repro_torch.train import TrainLoop, TrainLoopConfig, TrainStepConfig


def make_model(tiny: bool) -> LM:
    if tiny:
        return LM(
            LMConfig(
                name="lm-3m", family=ModelFamily.DENSE, n_layers=2,
                d_model=128, n_heads=4, n_kv_heads=2, d_ff=512, vocab=2048,
                segments=((("attn",), 2),), tie_embeddings=True,
            )
        )
    # ~100M params: 12L, d=768, llama-style
    return LM(
        LMConfig(
            name="lm-100m", family=ModelFamily.DENSE, n_layers=12,
            d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000,
            segments=((("attn",), 12),), tie_embeddings=True,
        )
    )


def synth_corpus(rng: np.random.Generator, n: int = 2_000_000, vocab: int = 32000):
    """Zipf-ish synthetic corpus with local structure (learnable)."""
    base = rng.zipf(1.3, n).clip(1, vocab - 1)
    # inject repeated phrases so the loss has something to learn
    phrase = rng.integers(1, vocab, 64)
    for start in range(0, n - 64, 997):
        if rng.random() < 0.3:
            base[start : start + 64] = phrase
    return base.astype(np.int32)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true", help="3M params for CI")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    store = ObjectStore(tempfile.mkdtemp())
    catalog = Catalog(store)
    fmt = TableFormat(store)
    rng = np.random.default_rng(0)

    model = make_model(args.tiny)
    vocab = model.cfg.vocab
    key = write_token_table(
        fmt, catalog, "corpus", synth_corpus(rng, vocab=vocab)
    )
    ds = TokenDataset(fmt, key, batch_size=args.batch, seq_len=args.seq, seed=0)

    cfg = TrainLoopConfig(
        total_steps=args.steps,
        checkpoint_every=max(args.steps // 6, 10),
        log_every=max(args.steps // 15, 5),
        async_checkpoint=True,
        max_final_loss=np.log(vocab),  # audit: must beat uniform
        step=TrainStepConfig(
            peak_lr=3e-4, warmup_steps=args.steps // 10,
            total_steps=args.steps, grad_clip=1.0,
        ),
    )

    # ---- phase 1: run just over half, then "crash"
    half = args.steps // 2 + 1
    loop = TrainLoop(model, ds, catalog, branch="train_main", config=cfg, device=args.device)
    loop.config.total_steps = half
    out1 = loop.run()
    print(f"[phase1] crashed at step {half}, loss {out1['final_loss']:.3f}")

    # ---- phase 2: restart — resumes from the last committed checkpoint
    loop2 = TrainLoop(model, ds, catalog, branch="train_main", config=cfg, device=args.device)
    loop2.config.total_steps = args.steps
    out2 = loop2.run()
    print(
        f"[phase2] resumed, ran {out2['steps_run']} more steps, "
        f"final loss {out2['final_loss']:.3f} (uniform={np.log(vocab):.3f})"
    )
    assert out2["audit_ok"], "final loss failed the audit gate"

    # ---- write: promote the audited checkpoint to main
    loop2.promote("main")
    head = catalog.head("main")
    print(f"promoted checkpoint to main @ {head.commit_id[:12]}: "
          f"{sorted(catalog.tables(branch='main'))}")
    return {"phase1": out1["losses"], "phase2": out2["losses"],
            "tables": sorted(catalog.tables(branch="main"))}


if __name__ == "__main__":
    main()
