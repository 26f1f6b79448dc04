"""Training substrate: optimizer, train step, checkpointing, compression.

The port of :mod:`repro.train` on one device.  Trees are the port's nested
dicts, lists and tuples of tensors (:mod:`.tree`).  Not ported yet:
``elastic.py`` and ``compression.compressed_psum``, which need the mesh
(ROADMAP queue 1 item 9).
"""
