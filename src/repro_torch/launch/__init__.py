"""Entry points of the port (counterpart of src/repro/launch)."""
