"""Training substrate: optimizer, train step, checkpointing, compression,
elastic restart.

The port of :mod:`repro.train`, on one device or a ``DeviceMesh`` (data
parallelism over the batch axes; :mod:`.train_step`).  Trees are the
port's nested dicts, lists and tuples of tensors (:mod:`.tree`).
"""
