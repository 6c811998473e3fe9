"""Diagnostics run from the command line (``python -m ...tools.<name>``)."""
