"""The compressive K-means pipeline: frequencies, operators, sketch engine,
ingest, windows, decoders and the Lloyd-Max baseline (counterpart of
``repro.core``).

The paper's pipeline is sketch -> decode behind one config:

    from repro_torch.core import CKMConfig, fit, sse

    res = fit(0, x, CKMConfig(k=10, decoder="sketch_shift"))

Submodules (``repro_torch.core.ckm``, ``.engine``, ``.quantize``,
``.topology``, ``.distributed_sketch``, ...) stay importable for internals.
"""

from repro_torch.core.ckm import (
    CKMConfig,
    CKMResult,
    compute_sketch,
    compute_sketch_streaming,
    decode_sketch,
    diagnose,
    fit,
    fit_streaming,
    predict,
    sse,
)
from repro_torch.core.decoders import (
    DECODERS,
    Decoder,
    available_decoders,
    get_decoder,
    register_decoder,
)
from repro_torch.core.engine import (
    BACKENDS,
    DecayedQuantizedSketchEngineState,
    DecayedSketchEngineState,
    SketchEngine,
)
from repro_torch.core.fleet import (
    FLEET_BACKENDS,
    FleetEngine,
    fleet_quantizers,
    fleet_specs,
)
from repro_torch.core.freq_ops import (
    FREQ_OPS,
    FreqOpSpec,
    FrequencyOperator,
    as_operator,
    available_freq_ops,
    make_operator,
    register_freq_op,
)
from repro_torch.core.ingest import BatchSource, IngestStats, ingest_stream, prefetched
from repro_torch.core.topology import (
    TOPOLOGIES,
    StragglerMerger,
    Topology,
    available_topologies,
    axis_reduce,
    reduce_states,
    register_topology,
    wire_cost_model,
)
from repro_torch.core.window import SketchWindow, WindowState

__all__ = [
    "CKMConfig",
    "CKMResult",
    "compute_sketch",
    "compute_sketch_streaming",
    "decode_sketch",
    "diagnose",
    "fit",
    "fit_streaming",
    "predict",
    "sse",
    "DECODERS",
    "Decoder",
    "available_decoders",
    "get_decoder",
    "register_decoder",
    "BACKENDS",
    "DecayedQuantizedSketchEngineState",
    "DecayedSketchEngineState",
    "SketchEngine",
    "FLEET_BACKENDS",
    "FleetEngine",
    "fleet_specs",
    "fleet_quantizers",
    "SketchWindow",
    "WindowState",
    "FREQ_OPS",
    "FreqOpSpec",
    "FrequencyOperator",
    "as_operator",
    "available_freq_ops",
    "make_operator",
    "register_freq_op",
    "BatchSource",
    "IngestStats",
    "ingest_stream",
    "prefetched",
    "TOPOLOGIES",
    "StragglerMerger",
    "Topology",
    "available_topologies",
    "axis_reduce",
    "reduce_states",
    "register_topology",
    "wire_cost_model",
]
