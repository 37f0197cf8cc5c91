#!/usr/bin/env python
"""Thin launcher for ``repro_torch.tools.plan`` when the package is not on
``sys.path`` (repo-root usage): ``python tools/plan_cli_torch.py ...`` is
identical to ``PYTHONPATH=src python -m repro_torch.tools.plan ...``.

The counterpart of ``tools/plan_cli.py`` in the port: it plans, saves,
loads, validates and (``--execute``) runs a deployment on ``--device``
(default ``cuda``; without a card it stops unless given ``--device
cpu``)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.tools.plan import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
