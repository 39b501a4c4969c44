"""Entry points of the port: `launch/serve.py`, the batched-prefill and
greedy-decode serving entry point."""
