"""The paper's primary contribution: the GFID dataflow (gfid.py), its analytic
performance model (analytics.py, Eqs 8-18) and the mode table (modes.py)."""
