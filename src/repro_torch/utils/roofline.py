"""Roofline accounting from a step's counted costs (counterpart of
``repro.utils.roofline``), with the H100's peaks in place of the v5e's.

All quantities are PER-DEVICE: the step ``utils.hlo`` costs is one rank's
program of an SPMD step, so its flops, bytes and collective bytes are one
card's numbers.

    compute_s    = flops / PEAK_FLOPS                (989 TFLOP/s dense bf16)
    memory_s     = bytes / HBM_BW                    (3.35 TB/s)
    collective_s = collective_bytes / LINK_BW        (50 GB/s a card)

The dominant term is the step-time lower bound; MODEL_FLOPS / flops
measures how much counted compute is useful (remat, replicated work).

The reference's ``parse_collectives`` reads optimized HLO text and has no
counterpart: ``utils.hlo.CostMode`` counts each collective as it is
dispatched.  ``analyze`` takes ``utils.hlo.Costs`` in place of a compiled
artifact.
"""

from __future__ import annotations

import dataclasses

# H100 SXM5, NVIDIA's data sheet: dense bf16 tensor-core peak (the 1979
# TFLOP/s the sheet prints is with 2:4 sparsity).
PEAK_FLOPS = 989e12
# H100 SXM5 data sheet: fp32 on the CUDA cores (non-tensor).
PEAK_FP32_FLOPS = 67e12
# H100 SXM5 data sheet: HBM3 bandwidth.
HBM_BW = 3.35e12
# One 400 Gb/s NDR InfiniBand port per card (the DGX H100's ConnectX-7, one
# a GPU): every 16-wide axis of a 16 x 16 mesh of 8-card nodes crosses
# nodes, so a collective's rate is the card's network port, not NVLink.
LINK_BW = 50e9


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int]
    count_by_op: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    hbm_bytes: float  # per device
    collective_bytes: float  # per device
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # global useful flops (6 N D)
    useful_ratio: float  # model_flops / (flops * chips)

    def bound_step_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """useful-compute time / bound step time (the score axis)."""
        t_useful = self.model_flops / self.chips / PEAK_FLOPS
        b = self.bound_step_time()
        return t_useful / b if b > 0 else 0.0


def analyze(costs, chips: int, model_flops: float) -> Roofline:
    """Roofline terms from a step's ``utils.hlo.Costs``."""
    flops = costs.flops
    hbm = costs.bytes
    coll = CollectiveStats(
        dict(costs.coll_by_op),
        {k: int(v) for k, v in costs.coll_count.items()},
    )
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    collective_s = coll.total_bytes / LINK_BW
    dominant = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", collective_s)],
        key=lambda kv: kv[1],
    )[0]
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        collective_bytes=float(coll.total_bytes),
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=model_flops / (flops * chips) if flops else 0.0,
    )


def freq_transform_model(
    n_pts: int, n: int, m: int, d: int, nblocks: int
) -> dict:
    """Flops/bytes/arithmetic-intensity model of the two frequency operators.

    Dense projection: one ``(N, n) @ (n, m)`` matmul — ``2·N·n·m`` flops
    moving ``4·(N·n + n·m + N·m)`` bytes.  Structured projection: per block,
    three Kronecker-factored WHTs (``H_d = H_a ⊗ H_b``; two dense
    contractions of ``2·N·d·(a+b)`` flops each) plus the diagonal and radial
    elementwise stages — ``O(N·m·sqrt(d))`` total, moving only
    ``4·(N·d + O(m) operator leaves + N·m)`` bytes.  The flops count
    dot-issued work only (``utils.hlo``'s cost model); elementwise
    trig/diagonals are excluded on both sides.
    """
    a = 1 << (((d.bit_length() - 1) + 1) // 2) if d > 1 else 1
    b = max(d // a, 1)
    dense_flops = 2.0 * n_pts * n * m
    structured_flops = 3.0 * nblocks * 2.0 * n_pts * d * (a + b)
    dense_bytes = 4.0 * (n_pts * n + n * m + n_pts * m)
    structured_bytes = 4.0 * (n_pts * d + 4 * nblocks * d + n_pts * m)
    return {
        "dense_flops": dense_flops,
        "structured_flops": structured_flops,
        "flops_ratio": dense_flops / max(structured_flops, 1.0),
        "dense_bytes": dense_bytes,
        "structured_bytes": structured_bytes,
        "dense_intensity": dense_flops / dense_bytes,
        "structured_intensity": structured_flops / structured_bytes,
    }


def train_model_flops(param_count: int, tokens: int) -> float:
    """6 N D (N = active params)."""
    return 6.0 * param_count * tokens


def decode_model_flops(param_count: int, batch: int) -> float:
    """One token per sequence: 2 N per token forward (decode has no backward)."""
    return 2.0 * param_count * batch
