"""Serving over the port's model stack."""
