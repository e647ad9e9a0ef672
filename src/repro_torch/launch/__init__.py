"""Launchers of the port's command-line entry points (`serve`)."""
