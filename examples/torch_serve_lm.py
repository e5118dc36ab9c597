"""Serve a model from a catalog branch with batched requests, on the
PyTorch port.

The edition of ``examples/serve_lm.py`` for ``repro_torch``: trains a
tiny LM for a few steps, commits the checkpoint, then checks it out and
serves a batch of prompts through the continuous-batching engine
(Query+Wrangle mode for models).  The checkpoint is the JAX package's
format; the serving ``LM`` is built from it by ``params_from_numpy``.
Serving runs on the card through the reference attention
(``use_flash_kernel`` off, as in the JAX edition); ``--device cpu`` runs
on the CPU.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import tempfile
from typing import List, Optional

import numpy as np

from repro_torch.catalog import Catalog
from repro_torch.data.tokens import TokenDataset, write_token_table
from repro_torch.io import ObjectStore
from repro_torch.models import LM, params_from_numpy
from repro_torch.models.lm import LMConfig, ModelFamily
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.table import TableFormat
from repro_torch.train import CheckpointManager, TrainLoop, TrainLoopConfig, TrainStepConfig
from repro_torch.train.step import make_train_state


def main(argv: Optional[List[str]] = None) -> List[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    store = ObjectStore(tempfile.mkdtemp())
    catalog = Catalog(store)
    fmt = TableFormat(store)
    rng = np.random.default_rng(0)

    model = LM(
        LMConfig(
            name="srv-lm", family=ModelFamily.DENSE, n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
            segments=((("attn",), 2),), tie_embeddings=True, max_decode_len=64,
        )
    )
    tokens = np.tile(rng.integers(1, 512, 512), 50).astype(np.int32)
    key = write_token_table(fmt, catalog, "corpus", tokens)
    ds = TokenDataset(fmt, key, batch_size=4, seq_len=32, seed=0)
    loop = TrainLoop(
        model, ds, catalog, branch="main", device=args.device,
        config=TrainLoopConfig(
            total_steps=30, checkpoint_every=15, log_every=10,
            step=TrainStepConfig(peak_lr=1e-3, warmup_steps=3, total_steps=30),
        ),
    )
    loop.run()

    # ---- check the artifact out of the catalog and serve it
    mgr = CheckpointManager(catalog, prefix=f"models/{model.cfg.name}")
    like = model.init_params(None)  # shapes and dtypes only (meta tensors)
    state_like = make_train_state(model, like, TrainStepConfig())
    (params, _), step = mgr.restore((like, state_like), branch="main", device=args.device)
    print(f"serving checkpoint from step {step}")

    served = params_from_numpy(params, model.cfg, device=args.device)
    engine = ServeEngine(served, None, ServeConfig(max_batch=3, max_len=64),
                         device=args.device)
    prompts = [
        np.array([5, 6, 7], np.int32),
        np.array([100, 101], np.int32),
        np.array([200], np.int32),
        np.array([1, 2, 3, 4], np.int32),  # queues for a free slot
    ]
    reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
    engine.generate(reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt={r.prompt.tolist()} -> {r.generated}")
    return reqs


if __name__ == "__main__":
    main()
