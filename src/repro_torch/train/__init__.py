"""Training on one card (counterpart of ``repro.train``): ``train_loop``
(``LoopConfig``, ``run``: checkpoints, restart, preemption, the activation
monitor and the compressive balancer) and ``monitor``
(``ActivationMonitor``)."""
