"""The JAX package's six examples (``examples/``) as drivers over the port,
one module each, run as ``python -m repro_torch.examples.<name>``:
``quickstart``, ``async_balancer``, ``pipeline_phases``, ``assembly_e2e``,
``serve_batched`` and ``train_moe_ccm``.  Each keeps its script's
arguments and printed lines and adds ``--device`` (``cuda`` by default,
which raises without a card; ``cpu`` runs the kernels' plain versions).
Each has ``main(argv=None)`` and a ``run(...)`` that prints those lines and
returns what they show, as numbers and result objects."""
