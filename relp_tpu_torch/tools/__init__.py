"""Diagnostic tools of the port, run from the command line."""
