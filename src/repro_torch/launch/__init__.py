"""Launchers: the LM training entry point and its ``--program`` front door."""
