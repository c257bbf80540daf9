"""Optimizers (counterpart of ``repro.optim``): ``optimizers`` (AdamW, its
int8-state twin, Adafactor, SGD; the warmup-cosine schedule; global-norm
clipping; each updating its own blocks on a mesh) and ``grad_compression``
(the int16 error-feedback gradient exchange across pods)."""
