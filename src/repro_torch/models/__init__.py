"""The LM substrate's models on one card (counterpart of ``repro.models``):
``layers`` (RMSNorm, RoPE, GQA and cross attention, SwiGLU, embeddings),
``moe`` (top-k routing, dispatch and dense expert paths), ``ssm`` (Mamba,
mLSTM, sLSTM) and ``transformer`` (``init_lm``, ``forward``, ``prefill``,
``decode_step``, ``init_cache``) for all ten architectures."""
