"""Launch descriptions (counterpart of ``repro.launch``): ``specs`` (a sketch
job's ``SketchJobSpec``; the LM's input specs and ``make_batch``), ``serve``
(the LM's prefill and serve steps), ``train`` (the train state and step),
both on one card or over a ``DeviceMesh``, ``mesh`` (the production
mesh's shape, a local ``DeviceMesh`` over the process group) and
``dryrun`` (one rank's step of the production mesh on fake tensors,
costed with the H100's roofline)."""

from repro_torch.launch.specs import SketchJobSpec

__all__ = ["SketchJobSpec"]
