"""Training launcher.

Counterpart of src/repro/launch/train.py, with its flags and its
`[train] ...` line, plus `--device` (the card unless it names another).
It trains with f32 master weights and bf16 compute on the synthetic
bigram task (`SyntheticLMDataset(fixed_map=True)`):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 50 --ckpt-dir /tmp/ckpt --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 3 --device cpu

The reference's `--dry-devices` sets an XLA flag for an ahead-of-time
compile on a virtual mesh; the port has no counterpart and refuses it.
The port's ahead-of-time look at a mesh is the dry run,
`python -m repro_torch.launch.dryrun`.
As in the reference, `--microbatches` is parsed but not passed on.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--state-dtype", default="fp32",
                    choices=("fp32", "bf16", "int8"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=("auto", "never"))
    ap.add_argument("--dry-devices", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.dry_devices:
        ap.error("--dry-devices sets an XLA flag for an ahead-of-time "
                 "compile on a virtual mesh; the PyTorch port has no "
                 "counterpart (its dry run: python -m "
                 "repro_torch.launch.dryrun)")

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.resume == "never" and args.ckpt_dir:
        import shutil

        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq,
                              fixed_map=True)
    res = run(
        cfg,
        LoopConfig(
            steps=args.steps,
            batch_size=args.batch,
            ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
        ),
        opt_cfg=AdamWConfig(lr=args.lr, state_dtype=args.state_dtype),
        data=data,
        install_signals=True,
        device=args.device,
    )
    print(
        f"[train] {cfg.name}: steps={res['steps_done']} "
        f"loss {res['losses'][0]:.3f} -> {res['losses'][-1]:.3f} "
        f"resumed_from={res['resumed_from']} events={len(res['events'])}"
    )
    return res


if __name__ == "__main__":
    main()
