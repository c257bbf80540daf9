"""Compressive K-means in PyTorch + CUDA — the port of the ``repro`` package.

Module for module this package mirrors ``src/repro/`` (``repro_torch.core.ckm``
is the counterpart of ``repro.core.ckm``), so a reader finds each function at
the same relative path.  It imports ``torch`` and numpy only: neither JAX nor
any ``repro`` module.

Device rule: every public entry point that creates data or runs the pipeline
takes ``device=`` and defaults to the CUDA card
(``repro_torch.device.DEFAULT``).  Without a card these entry points raise;
they run on the CPU only when the caller passes ``device="cpu"``.  Functions
that take tensors compute on their inputs' device: a CUDA tensor reaches the
CUDA kernel or an exception, a CPU tensor the kernel's plain version.

Randomness: ``torch.Generator`` objects take the place of JAX PRNG keys.  The
two frameworks draw different numbers from the same seed, so the port is held
to the reference on shared inputs (tests feed both from numpy), never on
matching random streams.
"""

from repro_torch.device import DEFAULT, resolve

__all__ = ["DEFAULT", "resolve"]
