"""The ``device=`` argument every public entry point takes, and the seeded
``torch.Generator`` streams that replace JAX PRNG keys."""

from __future__ import annotations

import numpy as np
import torch

# Entry points run on the card unless the caller asks for the CPU.
DEFAULT = "cuda"


def resolve(device: torch.device | str | None = DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but absent.

    There is no silent fallback: a caller that wants the CPU says so with
    ``device="cpu"``.
    """
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # Name the card, so the device compares equal to its tensors' devices.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def derive_seed(seed: int, *path: int) -> int:
    """An independent child seed of ``seed`` along ``path``.

    The counterpart of ``jax.random.split`` / ``fold_in``: numpy's
    ``SeedSequence`` hashes ``(seed, *path)``, so children of one parent are
    independent and ``derive_seed(s, r)`` for replicate ``r`` does not depend
    on how many replicates run.
    """
    state = np.random.SeedSequence([int(seed), *(int(p) for p in path)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def sync(device: torch.device) -> None:
    """Wait until the device has finished the work queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
