"""Checkpoints (counterpart of ``repro.checkpoint``): the atomic, async
:class:`~repro_torch.checkpoint.checkpointer.Checkpointer`, in the
reference's on-disk format, so a checkpoint written by either package
restores in the other."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
