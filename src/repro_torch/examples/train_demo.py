"""End-to-end training driver: a ~100M-parameter llama-family model for a
few hundred steps on synthetic data, with checkpoint and restart shown
mid-run.

Counterpart of examples/train_demo.py: `CFG_100M` (12 layers x 768), batch
8 x 256 of the fixed-map bigram task, AdamW with bf16 moments (lr 6e-4,
weight decay 0.01), a checkpoint every 25 steps; the run stops at half its
steps, restarts from the checkpoint and finishes, and the last ten losses
must average below the first ten.  The parameters are f32 masters drawn
from a `torch.Generator` seeded with 0 (`train.loop.run`).

    PYTHONPATH=src python -m repro_torch.examples.train_demo [--steps 200] \\
        [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import AdamWConfig

# ~100M params: 12L x 768 (llama-style)
CFG_100M = ModelConfig(
    name="demo-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=8192,
    head_dim=64,
    act="silu",
    norm="rms",
    tie_embeddings=True,
    rope_theta=10000.0,
)
SEQ_LEN = 256
CKPT_EVERY = 25
OPT = AdamWConfig(lr=6e-4, state_dtype="bf16", weight_decay=0.01)


def train_demo(cfg: ModelConfig = CFG_100M, steps: int = 200,
               batch: int = 8, ckpt_every: int = CKPT_EVERY, device=None,
               log=print) -> dict:
    """Run the example; returns both phases' `train.loop.run` summaries
    and the first and last ten losses' means."""
    log(f"model: {cfg.name} ({cfg.param_count() / 1e6:.0f}M params)")
    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=SEQ_LEN, seed=0,
                              fixed_map=True)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        half = steps // 2
        log(f"phase 1: steps 0..{half} (will checkpoint every "
            f"{ckpt_every})")
        res1 = run(
            cfg,
            LoopConfig(steps=half, batch_size=batch, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir, log_every=20),
            opt_cfg=OPT,
            data=data,
            device=device,
        )
        log(f"  loss {res1['losses'][0]:.3f} -> {res1['losses'][-1]:.3f}")

        log(f"phase 2: RESTART from checkpoint, continue to {steps}")
        res2 = run(
            cfg,
            LoopConfig(steps=steps, batch_size=batch, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir),
            opt_cfg=OPT,
            data=data,
            device=device,
        )
        log(f"  resumed from step {res2['resumed_from']}")
        log(f"  final loss {res2['losses'][-1]:.3f}")
        first = float(np.mean(res1["losses"][:10]))
        last = float(np.mean(res2["losses"][-10:]))
        assert last < first, "training did not reduce loss"
        log(f"OK — loss {first:.3f} -> {last:.3f} across a restart "
            f"boundary.")
    return {"phase1": res1, "phase2": res2, "first": first, "last": last}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    train_demo(steps=args.steps, batch=args.batch, device=args.device)


if __name__ == "__main__":
    main()
