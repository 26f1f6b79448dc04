"""Launchers of the port: serving (``launch/serve.py``) and single-device
training (``launch/train.py``)."""
