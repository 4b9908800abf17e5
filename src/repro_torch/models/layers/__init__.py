"""The model layers of the port (counterpart of src/repro/models/layers):
plain PyTorch ops mirroring the reference's arithmetic."""
