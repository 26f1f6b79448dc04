"""Serving on the port: the Lilac locality router, the batched step
certifier and the multi-pod engine with its two backends, the
roofline-priced ``SimBackend`` and ``RealBackend``, which decodes every
pod's sessions with the model and keeps their KV columns in one
``kvcache.KVStore`` per pod.
"""
