"""The model stack on PyTorch: configs, layers, decoder (port of :mod:`repro.models`).

Every registered architecture runs for inference (``forward``,
``prefill``, ``decode_step``, ``init_cache``): GQA attention (causal or
bidirectional, a sliding window on every layer or gemma3's local/global
pattern, partial rotary, M-RoPE, QK and gemma norms), MLA, Mamba2 (SSD)
and zamba2's shared attention block, with SwiGLU/GeGLU/ReLU²/GELU, MoE or
no FFN.  ``decoder.loss_fn`` trains them, and ``decoder.RunCtx.mesh``
runs them on a ``DeviceMesh`` (data parallelism, the sharded MoE paths,
seq-sharded KV rings; :mod:`.decoder`).
"""
