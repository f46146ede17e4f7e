"""Model-family registry (``candle_video_tpu/models/registry.py``).

Both families are live: ``ltx_video`` (text- and image-to-video,
``LtxPipeline``) and ``svd`` (image-to-video, ``SvdPipeline``).
``build_pipeline(name, **kwargs)`` passes the keywords to the family's
pipeline class.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def available() -> list[str]:
    return sorted(_REGISTRY)


def build_pipeline(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model family '{name}'; available: {available()}")
    return _REGISTRY[name](**kwargs)


@register("ltx_video")
def _build_ltx(**kwargs):
    from .ltx_video.pipeline import LtxPipeline

    return LtxPipeline(**kwargs)


@register("svd")
def _build_svd(**kwargs):
    from .svd.pipeline import SvdPipeline

    return SvdPipeline(**kwargs)
