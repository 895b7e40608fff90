"""Checkpoints of the port's trees in the reference's ``arrays.npz`` +
``manifest.json`` format (``repro_torch.checkpoint.checkpoint``), and the
asynchronous snapshot engine over them
(``repro_torch.checkpoint.async_engine``)."""
from .async_engine import (STEP_PREFIX, AsyncCheckpointEngine, SnapshotError,
                           blocking_equivalent, list_steps, step_dir)

__all__ = ["STEP_PREFIX", "AsyncCheckpointEngine", "SnapshotError",
           "blocking_equivalent", "list_steps", "step_dir"]
