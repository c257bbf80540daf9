"""What the kernel wrappers share at launch: the device checks and the grid
sizing of the row-range kernels."""

from __future__ import annotations

import torch

# Blocks the grid aims for per SM, and the rows a block sums at least (where
# N allows) and at most (a float partial's register accumulators stay
# accurate over that many rows).
_BLOCKS_PER_SM = 8
_MIN_ROWS_PER_GROUP = 256
_MAX_ROWS_PER_GROUP = 16384


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


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def grid_rows(n_pts: int, col_blocks: int, sms: int) -> tuple[int, int]:
    """``(rows_per_group, groups)`` for a grid of ``groups`` row ranges by
    ``col_blocks`` column blocks: about ``_BLOCKS_PER_SM`` blocks per SM, at
    least ``_MIN_ROWS_PER_GROUP`` rows a block where N allows, at most
    ``_MAX_ROWS_PER_GROUP``.  A fixed function of the shape on one card, so a
    fixed-order reduction over the groups repeats its bits."""
    groups = max(1, -(-_BLOCKS_PER_SM * sms // col_blocks))
    groups = min(groups, max(1, -(-n_pts // _MIN_ROWS_PER_GROUP)))
    groups = max(groups, -(-n_pts // _MAX_ROWS_PER_GROUP))
    rows = max(1, -(-n_pts // groups))
    return rows, max(1, -(-n_pts // rows))
