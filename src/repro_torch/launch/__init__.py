"""Launch descriptions (counterpart of ``repro.launch``): ``specs`` (a sketch
job's ``SketchJobSpec``; the LM's input specs and ``make_batch``), ``serve``
(the LM's prefill and serve steps on one card) and ``train`` (the train
state and step on one card).  The reference's ``mesh`` launcher is ROADMAP
Queue 1 item 22 (b), part 2, and ``dryrun`` item 23."""

from repro_torch.launch.specs import SketchJobSpec

__all__ = ["SketchJobSpec"]
