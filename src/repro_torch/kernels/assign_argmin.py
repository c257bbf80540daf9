"""Fused nearest-centroid assignment: the CUDA kernel and its plain twin.

Counterpart of ``repro.kernels.assign_argmin.assign_argmin_kernel``.  Both
functions here return, for ``x (N, n)`` and ``c (K, n)``:

    (labels (N,) int32 — argmin_k ||x_i - c_k||^2, ties to the lowest k,
     min_dist (N,) float32 — min_k ||x_i - c_k||^2)

- :func:`assign_argmin` launches ``csrc/assign_argmin.cu`` on a CUDA tensor
  (or raises) and counts each launch in ``LAUNCHES``;
- :func:`assign_argmin_plain` is the plain PyTorch version, written as the
  reference oracle ``repro.kernels.ref.assign_argmin_ref`` is.

:func:`assign_plan` picks the kernel's path, grid and shared memory from
``(N, n, K)``; the CUDA source derives the same plan and refuses another.
``kernels.ops`` picks between the kernel and the plain version by the
tensor's device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, on_device, stream_ptr

# Kernel launches since the count was last reset (plain calls do not count).
LAUNCHES = 0

# The point path: one thread a point, rows of up to POINT_MAX_N features held
# in registers, blocks of POINT_THREADS, centroids staged in tiles within the
# 48 KB a block has without opting in.
POINT_MAX_N, POINT_THREADS, POINT_SMEM_FLOATS = 64, 256, 48 * 1024 // 4
# The tile path: TILE_POINTS points a CTA, centroid tiles of TILE_CENTROIDS,
# feature chunks of TILE_FEATURES through a ring of TILE_STAGES, centroid
# rows staged TILE_FEATURES + 4 floats wide.
TILE_POINTS, TILE_CENTROIDS, TILE_FEATURES, TILE_STAGES = 64, 64, 32, 2
# The switch, measured at N = 10^6 (tools/kernel_variants.py): at
# n <= POINT_MAX_N the point path keeps n <= TILE_MIN_N and n K < TILE_MIN_NK.
TILE_MIN_N, TILE_MIN_NK = 17, 1536
# Shared memory a block may have on an H100 (227 KB, opted in).
SMEM_MAX = 232_448


class AssignPlan(NamedTuple):
    path: str  # "point" or "tile"
    resident: bool  # tile path: the CTA's point rows stay staged across centroid tiles
    grid: int  # CTAs
    smem: int  # dynamic shared memory a CTA, bytes


def _point_np(n: int) -> int:
    return next(np_ for np_ in (4, 8, 12, 16, 32, 64) if n <= np_)


def tile_smem(n: int, resident: bool) -> int:
    """Bytes of the tile kernel's shared memory: the point rows (the whole
    padded row when resident, else a chunk a ring stage), the ring's centroid
    chunks, the tile's ||c||^2, the points' ||x||^2 and the (d, k) pairs of
    the cross-warp merge."""
    chunks = -(-n // TILE_FEATURES) if resident else TILE_STAGES
    floats = (TILE_POINTS * (chunks * TILE_FEATURES + 4)
              + TILE_STAGES * TILE_CENTROIDS * (TILE_FEATURES + 4) + TILE_CENTROIDS)
    return 4 * (floats + 2 * TILE_POINTS) + 4 * TILE_POINTS


def assign_plan(n_pts: int, n: int, k: int, path: str | None = None,
                resident: bool | None = None) -> AssignPlan:
    """The launch of ``csrc/assign_argmin.cu`` for ``x (n_pts, n)`` and
    ``c (k, n)``: the point path at ``n <= POINT_MAX_N`` unless ``n >=
    TILE_MIN_N`` and ``n k >= TILE_MIN_NK``, the tile path otherwise.  The
    tile path keeps its point rows resident when K spans more than one
    centroid tile and two CTAs still fit an SM (``SMEM_MAX``).  ``path``
    and ``resident`` force a choice (for timing the alternatives)."""
    if path is None:
        point = n <= POINT_MAX_N and (n < TILE_MIN_N or n * k < TILE_MIN_NK)
        path = "point" if point else "tile"
    if path == "point":
        if n > POINT_MAX_N:
            raise ValueError(f"the point path holds n <= {POINT_MAX_N}, got {n}")
        np_ = _point_np(n)
        k_tile = min(k, POINT_SMEM_FLOATS // (np_ + 1))
        return AssignPlan("point", False, -(-n_pts // POINT_THREADS), 4 * k_tile * (np_ + 1))
    if path != "tile":
        raise ValueError(f"path must be 'point' or 'tile', got {path!r}")
    if resident is None:
        resident = k > TILE_CENTROIDS and 2 * tile_smem(n, True) <= SMEM_MAX
    return AssignPlan("tile", resident, -(-n_pts // TILE_POINTS), tile_smem(n, resident))


# Devices whose tile kernel may use SMEM_MAX (assign_argmin_init ran there).
_READY: set[int] = set()
# The wrapper's plans by (N, n, K): a plan costs ~2 us of host time, which
# shows in a launch this short.
_PLANS: dict[tuple[int, int, int], AssignPlan] = {}


def _lib(device: torch.device) -> ctypes.CDLL:
    lib = _build.load("assign_argmin")
    fn = lib.assign_argmin
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, i64, i64, ptr, ptr, ptr]
        fn.restype = i32
        lib.assign_argmin_init.argtypes = []
        lib.assign_argmin_init.restype = i32
        lib.assign_argmin_error_string.argtypes = [i32]
        lib.assign_argmin_error_string.restype = ctypes.c_char_p
    if device.index not in _READY:
        status = lib.assign_argmin_init()
        if status != 0:
            msg = lib.assign_argmin_error_string(status).decode()
            raise RuntimeError(f"assign_argmin: shared-memory opt-in failed: {msg} ({status})")
        _READY.add(device.index)
    return lib


def _check_inputs(x: torch.Tensor, c: torch.Tensor) -> None:
    if x.ndim != 2 or c.ndim != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(
            f"expected x (N, n) and c (K, n); got {tuple(x.shape)}, {tuple(c.shape)}"
        )
    if c.shape[0] < 1:
        raise ValueError("need at least one centroid")
    for name, t in (("x", x), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def assign_argmin(x: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: ``(labels (N,) int32, min_dist (N,) float32)``.

    Raises for anything the kernel does not take (a CPU tensor, another
    dtype, a non-contiguous tensor, mismatched devices).
    """
    global LAUNCHES
    _check_inputs(x, c)
    dev = check_cuda((("x", x), ("c", c)))
    n_pts, n = x.shape
    k = c.shape[0]
    plan = _PLANS.get((n_pts, n, k))
    if plan is None:
        if len(_PLANS) >= 1024:
            _PLANS.clear()
        plan = _PLANS[n_pts, n, k] = assign_plan(n_pts, n, k)
    # new_empty: the cheapest allocation on the host, whose time shows in a
    # launch this short (tens of microseconds at N ~ 10^4).
    labels = x.new_empty(n_pts, dtype=torch.int32)
    dist = x.new_empty(n_pts)
    with on_device(dev):
        lib = _lib(dev)
        status = lib.assign_argmin(
            x.data_ptr(), c.data_ptr(), n_pts, n, k, plan.path == "tile", plan.resident,
            plan.grid, plan.smem, labels.data_ptr(), dist.data_ptr(), stream_ptr(dev),
        )
    if status != 0:
        msg = lib.assign_argmin_error_string(status).decode()
        raise RuntimeError(f"assign_argmin kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return labels, dist


def assign_argmin_plain(
    x: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version over the full ``(N, K)`` distance matrix."""
    _check_inputs(x, c)
    d2 = (
        torch.sum(x * x, dim=1, keepdim=True)
        - 2.0 * x @ c.T
        + torch.sum(c * c, dim=1)[None, :]
    )
    return torch.argmin(d2, dim=1).to(torch.int32), torch.amin(d2, dim=1)
