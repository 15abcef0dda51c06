"""Diagnostic tools that run on the card."""
