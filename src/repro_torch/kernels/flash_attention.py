"""Flash attention (forward, online softmax): the CUDA kernel and its plain
twin.

Counterpart of ``repro.kernels.flash_attention.flash_attention_kernel``.  For
``q (BH, S_q, hd)`` and ``k, v (BKV, S_kv, hd)`` (heads flattened, q row
``h`` reading k/v row ``h // rep``), both functions here return

    (o (BH, S_q, hd) in q's dtype, lse (BH, S_q) float32)

with scale ``1/sqrt(hd)``, the causal and sliding-window masks from absolute
positions, masked scores at -1e30 (so a row with no key at all takes the mean
of V, as in the reference) and float32 accumulation:

- :func:`flash_attention_kernel` launches ``csrc/flash_attention.cu`` on
  CUDA tensors (or raises) and counts each launch in ``LAUNCHES``; given CPU
  tensors it runs the plain version;
- :func:`flash_attention_plain` is the oracle's math
  (``repro.kernels.ref.flash_attention_ref``) in float32, with the LSE, over
  q chunks of ``q_chunk`` rows so that a long sequence fits.

``kernels.ops.flash_attention`` is the entry point, with the reference's
``(B, S, H, hd)`` layout.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, on_device, stream_ptr

# Kernel launches since the count was last reset (plain calls do not count).
LAUNCHES = 0

MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr] + [i32] * 7 + [ctypes.c_float, i32, ptr]
        fn.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(q, k, v, rep: int, window: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(
            f"expected q (BH, S_q, hd), k and v (BKV, S_kv, hd); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, s_q, hd = q.shape
    if k.shape[2] != hd or rep < 1 or k.shape[0] * rep != bh:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, rep {rep} "
            "(need BKV * rep = BH and one head width)"
        )
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head width {hd} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]")
    if s_q < 1 or k.shape[1] < 1:
        raise ValueError(f"empty sequence: S_q = {s_q}, S_kv = {k.shape[1]}")
    if window < 0:
        raise ValueError(f"window must be >= 0 (0: none), got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share one dtype of {_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}"
        )


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rep: int = 1,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.

    Raises for anything the kernel does not take (mixed devices, another
    dtype, a non-contiguous tensor, a head width that is not a multiple of 8
    up to 256, more than 65,535 q rows of heads, a bf16 tensor whose data
    is not 16-byte aligned for the kernel's copies).
    """
    global LAUNCHES
    _check_inputs(q, k, v, rep, window)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, rep, causal, window)
    dev = check_cuda((("q", q), ("k", k), ("v", v)))
    bh, s_q, hd = q.shape
    if bh > 65535:
        raise ValueError(f"{bh} flattened heads exceed the kernel's grid (65,535)")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on 16-byte boundaries")
    lib = _lib()
    with on_device(dev):
        o = torch.empty_like(q)
        lse = torch.empty((bh, s_q), dtype=torch.float32, device=dev)
        status = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, s_q, k.shape[1], hd, rep, int(bool(causal)), int(window), 1.0 / hd**0.5,
            int(q.dtype == torch.bfloat16), stream_ptr(dev),
        )
    if status != 0:
        msg = lib.flash_attention_error_string(status).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({status})")
    LAUNCHES += 1
    return o, lse


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rep: int = 1,
    causal: bool = True,
    window: int = 0,
    q_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: softmax attention over the full masked
    ``(S_q, S_kv)`` scores in float32, ``q_chunk`` q rows at a time (all of
    them when ``None``); ``(o in q's dtype, lse float32)``."""
    _check_inputs(q, k, v, rep, window)
    bh, s_q, hd = q.shape
    bkv, s_kv, _ = k.shape
    kf = k.to(torch.float32)[:, None]  # (BKV, 1, S_kv, hd): shared by rep heads
    vf = v.to(torch.float32)[:, None]
    kpos = torch.arange(s_kv, device=q.device)[None, :]
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    chunk = s_q if q_chunk is None else q_chunk
    for q0 in range(0, s_q, chunk):
        q1 = min(s_q, q0 + chunk)
        qc = q[:, q0:q1].to(torch.float32).reshape(bkv, rep, q1 - q0, hd)
        s = torch.matmul(qc, kf.transpose(-1, -2)) / math.sqrt(hd)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        mask = torch.ones((q1 - q0, s_kv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window > 0:
            mask &= (qpos - kpos) < window
        s = torch.where(mask, s, -1e30)
        lse[:, q0:q1] = torch.logsumexp(s, dim=-1).reshape(bh, q1 - q0)
        oc = torch.matmul(torch.softmax(s, dim=-1), vf)
        o[:, q0:q1] = oc.reshape(bh, q1 - q0, hd).to(q.dtype)
    return o, lse
