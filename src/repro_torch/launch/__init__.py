"""Launchers of the port: the LM serving launcher (``launch/serve.py``)."""
