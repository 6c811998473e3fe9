"""Run-directory utilities of the train entry point: metrics log and
checkpoints."""
