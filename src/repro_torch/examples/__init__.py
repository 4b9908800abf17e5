"""The examples of the port (counterpart of the repository's `examples/`):
`quickstart`, `sssp`, `serve_demo` and `train_demo`, each run as
``python -m repro_torch.examples.<name>`` on the card unless `--device`
names another."""
