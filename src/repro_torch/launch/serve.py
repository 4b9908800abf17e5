"""Serving launcher: SmartPQ continuous batching over a synthetic workload,
decoding with a randomly initialized model.

Counterpart of src/repro/launch/serve.py, with its flags and its workload
(`numpy.random.default_rng(0)`: bursts of `--burst` requests, each
followed by 4 empty ticks), plus `--device` (the card unless it names
another).  The parameters come from a `torch.Generator` seeded with 0, as
the reference's from `jax.random.key(0)` (a stream PyTorch cannot
reproduce):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --reduced --device cpu

Any arch serves (`--arch granite-moe-3b-a800m`, `--arch mamba2-780m`,
`--arch whisper-base`, `--arch llama-3.2-vision-11b`; jamba-1.5-large-398b
fits one card only with `--reduced`).
"""

import argparse


def workload(n_requests: int, burst: int):
    """The reference launcher's arrivals, tick by tick."""
    import numpy as np

    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng(0)
    ticks, uid = [], 0
    while uid < n_requests:
        arrivals = []
        for _ in range(min(burst, n_requests - uid)):
            arrivals.append(
                Request(
                    uid=uid,
                    prompt_len=int(rng.integers(4, 16)),
                    max_new_tokens=int(rng.integers(2, 6)),
                    slo_class=int(rng.integers(0, 3)),
                )
            )
            uid += 1
        ticks.append(arrivals)
        ticks.extend([[]] * 4)
    return ticks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--burst", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(
        torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(
        cfg, params, EngineConfig(batch_size=args.slots, max_seq=args.max_seq),
        device=model.device,
    )
    summary = engine.run(workload(args.requests, args.burst),
                         max_steps=10_000)
    print(
        f"[serve] {cfg.name}: {summary['completed']}/{args.requests} requests "
        f"in {summary['steps']} steps ({summary['wall_s']:.1f}s), "
        f"pq transitions={summary['pq_transitions']}"
    )
    return summary


if __name__ == "__main__":
    main()
