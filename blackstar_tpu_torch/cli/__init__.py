"""Command-line entry points: render."""
