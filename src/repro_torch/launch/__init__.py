"""Launch descriptions (counterpart of ``repro.launch``): ``specs`` (a sketch
job's ``SketchJobSpec``; the LM's input specs and ``make_batch``) and
``serve``, the LM's prefill and serve steps on one card.  The reference's
``train``, ``dryrun`` and ``mesh`` launchers wait for the LM's training half
(ROADMAP Queue 1 item 22 (b))."""

from repro_torch.launch.specs import SketchJobSpec

__all__ = ["SketchJobSpec"]
