"""Host surface: image IO, run configuration, film checkpoints, the CLI."""
