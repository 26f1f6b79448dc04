"""Serving on the port: the Lilac locality router, the batched step
certifier and the multi-pod engine with its roofline-priced ``SimBackend``.

The real decode backend and its KV-session store are not ported yet
(ROADMAP queue 1 item 8).
"""
