"""Checkpoints of the port's trees in the reference's ``arrays.npz`` +
``manifest.json`` format (``repro_torch.checkpoint.checkpoint``)."""
