"""Optimizers (counterpart of ``repro.optim``): ``optimizers`` (AdamW, its
int8-state twin, Adafactor, SGD; the warmup-cosine schedule; global-norm
clipping).  ``grad_compression`` waits for the LM on a mesh (ROADMAP Queue 1
item 22 (b), part 2)."""
