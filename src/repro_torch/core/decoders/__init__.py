"""Pluggable sketch decoders — the decode half of sketch -> decode.

A ``Decoder`` protocol + registry (``registry.py``); importing this package
registers ``"clompr"`` (paper Algorithm 1).  The reference's ``sketch_shift``
and ``amp`` decoders are still to be ported.
"""

from repro_torch.core.decoders.registry import (
    DECODERS,
    Decoder,
    available_decoders,
    get_decoder,
    register_decoder,
)

# Importing the built-in decoder modules registers them.
from repro_torch.core.decoders.clompr import CLOMPRConfig, clompr

__all__ = [
    "DECODERS",
    "Decoder",
    "available_decoders",
    "get_decoder",
    "register_decoder",
    "CLOMPRConfig",
    "clompr",
]
