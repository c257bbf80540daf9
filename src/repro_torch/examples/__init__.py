"""The reference's examples as modules of the port (counterparts of
``examples/quickstart.py``, ``full_pipeline.py``, ``serve_fleet.py``,
``serve_kv_ckm.py`` and ``train_lm.py``):

    python -m repro_torch.examples.quickstart [--n 50000] [--device cuda]
    python -m repro_torch.examples.full_pipeline [--backend kernel|sharded] ...
    python -m repro_torch.examples.serve_fleet [--shards P] [--devices N] ...
    python -m repro_torch.examples.serve_kv_ckm [--device cuda]
    python -m repro_torch.examples.train_lm [--arch llama3.2-1b] [--steps 200] [--device cuda]

Each keeps the reference's flags and output lines and adds ``--device``
(default the card; ``--device cpu`` runs the plain kernels on the CPU).
Each has a ``main(argv)`` entry point.
"""
