"""Command-line interface."""
