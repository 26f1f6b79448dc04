"""Launchers of the port: the serving entry point (``launch/serve.py``)."""
