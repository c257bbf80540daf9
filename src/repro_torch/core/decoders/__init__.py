"""Pluggable sketch decoders — the decode half of sketch -> decode.

A ``Decoder`` protocol + registry (``registry.py``); importing this package
registers the reference's three built-ins: ``"clompr"`` (paper Algorithm 1),
``"sketch_shift"`` (mean shift on the residual sketched density) and
``"amp"`` (CL-AMP: joint approximate message passing, for small m).  Select
one end to end with ``CKMConfig(decoder=...)``.
"""

from repro_torch.core.decoders.registry import (
    DECODERS,
    Decoder,
    available_decoders,
    get_decoder,
    register_decoder,
)

# Importing the built-in decoder modules registers them.
from repro_torch.core.decoders.amp import AMPConfig, cl_amp
from repro_torch.core.decoders.clompr import CLOMPRConfig, clompr
from repro_torch.core.decoders.sketch_shift import SketchShiftConfig, sketch_shift

__all__ = [
    "DECODERS",
    "Decoder",
    "available_decoders",
    "get_decoder",
    "register_decoder",
    "AMPConfig",
    "cl_amp",
    "CLOMPRConfig",
    "clompr",
    "SketchShiftConfig",
    "sketch_shift",
]
