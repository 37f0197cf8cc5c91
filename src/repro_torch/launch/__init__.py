"""Launchers of the port: LM serving (``launch/serve.py``) and training
(``launch/train.py``) on one device."""
