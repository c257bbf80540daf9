"""Back-compat adapter: CLOMPR lives in the decoder subsystem (counterpart of
``repro.core.clompr``).

The implementation is ``repro_torch.core.decoders.clompr`` (the
``"clompr"`` entry of the decoder registry); this module re-exports it so
``from repro_torch.core.clompr import CLOMPRConfig, clompr`` works as the
reference's import does.  New code should go through the registry
(``repro_torch.core.decoders.get_decoder``) or ``CKMConfig.decoder``.
"""

from repro_torch.core.decoders.clompr import CLOMPRConfig, InitStrategy, clompr

__all__ = ["CLOMPRConfig", "InitStrategy", "clompr"]
