"""The model stack on PyTorch: configs, layers, decoder (port of :mod:`repro.models`).

Ported so far, for inference (``forward``, ``prefill``, ``decode_step``,
``init_cache``): dense GQA attention (with a sliding window on every
layer), MLA and Mamba2 (SSD) mixers, with dense, MoE or no FFN.  Shared
attention and the features of ``common.unported_features`` raise
``NotImplementedError`` (ROADMAP queue 1 item 8).
"""
