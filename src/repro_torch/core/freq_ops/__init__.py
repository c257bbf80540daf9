"""Pluggable frequency operators (``core.freq_ops``) — see ``base.py``.

Two families are registered: the paper's ``"dense"`` matrix and the
``"structured"`` fast-transform blocks.
"""

from repro_torch.core.freq_ops.base import (
    FREQ_OPS,
    FreqOpSpec,
    FrequencyOperator,
    as_operator,
    available_freq_ops,
    from_spec,
    get_freq_op,
    make_operator,
    register_freq_op,
    seeded_operator,
    spec_wire_bytes,
    StackedOperator,
)
from repro_torch.core.freq_ops.dense import DenseOperator
from repro_torch.core.freq_ops.structured import StructuredOperator

__all__ = [
    "FREQ_OPS",
    "FreqOpSpec",
    "FrequencyOperator",
    "DenseOperator",
    "StructuredOperator",
    "as_operator",
    "available_freq_ops",
    "from_spec",
    "get_freq_op",
    "make_operator",
    "register_freq_op",
    "seeded_operator",
    "spec_wire_bytes",
    "StackedOperator",
]
