"""Utilities of the port (the fixtures' closed-form input)."""
