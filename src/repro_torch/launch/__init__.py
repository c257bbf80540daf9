"""Launch descriptions (counterpart of ``repro.launch``): ``specs.SketchJobSpec``,
how a sketch job is deployed.  The reference's LM launchers (``train``,
``serve``, ``dryrun``, ``mesh``) belong to the LM substrate (ROADMAP Queue 1
item 22)."""

from repro_torch.launch.specs import SketchJobSpec

__all__ = ["SketchJobSpec"]
