"""Test-support layer: deterministic fault injection (``chaos.py``) and
the virtual-time churn replay (``churn.py``). Not imported by the serving
path."""
