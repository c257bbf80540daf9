"""What the kernel wrappers share at launch: the device checks, the card's
SM count and current stream, and the grid sizing of the row-range kernels."""

from __future__ import annotations

import contextlib
import functools

import torch

# The rows a block sums at least, where N allows.
_MIN_ROWS_PER_GROUP = 256


def check_cuda(named) -> torch.device:
    """Each ``(name, tensor)`` (``None`` skipped) is a contiguous CUDA tensor
    on the first one's device; returns that device or raises."""
    dev = named[0][1].device
    for name, t in named:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    return _sm_count(dev.index)


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)``, or nothing when ``dev`` is current
    already: the switch and back cost about as much as a small launch."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream_ptr(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current CUDA stream (what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without building
    a ``Stream``: a small launch's host time matters)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def grid_rows(
    n_pts: int, col_blocks: int, sms: int, resident: int, min_rows: int = _MIN_ROWS_PER_GROUP,
) -> tuple[int, int]:
    """``(rows_per_group, groups)`` for a grid of ``groups`` row ranges by
    ``col_blocks`` column blocks: given the kernel's ``resident`` blocks per
    SM (its occupancy), at most one wave of them, so no SM gets a second,
    ragged round; at least ``min_rows`` rows a block where N allows, and no
    cap (the kernels keep long sums accurate themselves: double tile sums,
    or exact int32).  A fixed function of the shape on one card, so a
    fixed-order reduction over the groups repeats its bits."""
    groups = max(1, resident * sms // col_blocks)
    groups = min(groups, max(1, -(-n_pts // min_rows)))
    rows = max(1, -(-n_pts // groups))
    return rows, max(1, -(-n_pts // rows))
