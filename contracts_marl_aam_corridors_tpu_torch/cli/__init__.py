"""Command-line entry points: ``python -m
contracts_marl_aam_corridors_tpu_torch.cli.train`` (graph-path training)."""
