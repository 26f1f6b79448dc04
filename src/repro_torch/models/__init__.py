"""The model stack on PyTorch: configs, layers, decoder (port of :mod:`repro.models`).

Ported so far: dense GQA attention and Mamba2 (SSD) mixers with dense or no
FFN, for inference (``forward``, ``prefill``, ``decode_step``,
``init_cache``).  MLA, MoE and shared-attention layers raise
``NotImplementedError`` (ROADMAP queue 1 item 8).
"""
