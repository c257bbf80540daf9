"""Pluggable frequency operators (``core.freq_ops``) — see ``base.py``.

This slice registers the paper's ``"dense"`` operator; the structured
fast-transform family is still to be ported.
"""

from repro_torch.core.freq_ops.base import (
    FREQ_OPS,
    FrequencyOperator,
    as_operator,
    available_freq_ops,
    get_freq_op,
    make_operator,
    register_freq_op,
)
from repro_torch.core.freq_ops.dense import DenseOperator

__all__ = [
    "FREQ_OPS",
    "FrequencyOperator",
    "DenseOperator",
    "as_operator",
    "available_freq_ops",
    "get_freq_op",
    "make_operator",
    "register_freq_op",
]
