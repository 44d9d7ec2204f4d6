"""Launchers: the LM training entry point and its ``--program`` front door,
the serve launcher, and the data-parallel node mesh (``mesh.py``)."""
