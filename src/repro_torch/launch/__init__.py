"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, and the host-only dry-run
``python -m repro_torch.launch.dryrun`` with its diagnostic
``python -m repro_torch.launch.diag`` (over ``mesh`` and ``sharding``)."""
