"""The LM substrate's models, the dense family on one card (counterpart of
``repro.models``): ``layers`` (RMSNorm, RoPE, GQA attention, SwiGLU,
embeddings) and ``transformer`` (``init_lm``, ``forward``, ``prefill``,
``decode_step``, ``init_cache``).  ``moe`` and ``ssm`` wait for ROADMAP
Queue 1 item 22 (c)."""
