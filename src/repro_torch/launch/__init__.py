"""Launchers of the port: the mesh record and the training CLI."""
