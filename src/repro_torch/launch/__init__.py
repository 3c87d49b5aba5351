"""Entry points: the training CLI."""
