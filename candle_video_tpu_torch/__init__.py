"""candle_video_tpu_torch — the LTX-Video text-to-video path in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package ``candle_video_tpu`` that stays beside it as the
reference.  Layout mirrors it module for module: ``ops/`` (norms,
activations, embeddings, RoPE, attention, conv3d), ``ops/kernels/`` (the
kernel wrappers and their plain versions), ``csrc/`` (the CUDA sources),
``models/ltx_video/`` (configs, scheduler, DiT, T5, VAE decoder, pipeline,
weight conversion), ``models/registry.py``, ``quant/`` (GGUF reader),
``utils/`` (PCG32, tokenizer, video export, debug utilities), ``serving.py``
(shape buckets, continuous batching) and ``cli.py``.  Nothing here imports JAX or
``candle_video_tpu``: the jax-free modules it needs are copied here.
"""

__version__ = "0.1.0"
