"""Application workloads that drive the port (counterpart of
src/repro/workloads): so far the paper's phased traces (`traces`)."""
