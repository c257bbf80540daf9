"""Cost accounting (counterpart of ``repro.utils``): ``hlo`` costs a traced
torch program op by op (flops, bytes, collectives, live bytes), ``roofline``
turns those costs into the H100's roofline terms.  The reference's
``compat`` (JAX API shims) has no counterpart."""
