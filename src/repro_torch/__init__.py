"""PyTorch/CUDA port of the Tahoma reproduction (``src/repro`` is the JAX
reference). Same module layout and names as ``repro``; this package
imports neither ``jax`` nor ``repro``.

Entry points (``ModelBank``/``TahomaSystem`` construction,
``evaluate_cascades_streaming``, ``ScanEngine``, ``build_scan_engine``,
``params_from_jax``) run on ``"cuda"`` unless the caller passes
``device="cpu"``; without a card they raise instead of carrying on
quietly on the CPU (``repro_torch.device.resolve_device``).
"""
