"""The port's public loaders, and the converters that carry the JAX
package's trees into its modules, put a model on the GPU unless told
otherwise: called without a device on a machine with no CUDA, each raises
instead of loading the model to the CPU."""

import pytest
import torch

from candle_video_tpu_torch.models.ltx_video import convert as LCV
from candle_video_tpu_torch.models.ltx_video import loader as LL
from candle_video_tpu_torch.models.ltx_video import t5 as PT5
from candle_video_tpu_torch.models.ltx_video.configs import (LtxTransformerConfig,
                                                             LtxVaeConfig, T5Config)
from candle_video_tpu_torch.models.svd import clip as PC
from candle_video_tpu_torch.models.svd import configs as PCFG
from candle_video_tpu_torch.models.svd import convert as SCV
from candle_video_tpu_torch.models.svd import loader as PL
from candle_video_tpu_torch.models.svd import vae as PV

LOADERS = {
    "t5_from_gguf": lambda: PT5.t5_from_gguf("no-such-file.gguf", T5Config()),
    "unet_params_from_state_dict": lambda: PL.unet_params_from_state_dict({}),
    "vae_params_from_state_dict": lambda: PV.vae_params_from_state_dict({}),
    "clip_params_from_hf_state_dict":
        lambda: PC.params_from_hf_state_dict({}, PCFG.ClipEncoderConfig()),
    "transformer_from_state_dict":
        lambda: LL.transformer_from_state_dict({}, LtxTransformerConfig()),
    "transformer_w8_from_state_dict":
        lambda: LL.transformer_w8_from_state_dict({}, LtxTransformerConfig()),
    "transformer_w4_from_state_dict":
        lambda: LL.transformer_w4_from_state_dict({}, LtxTransformerConfig()),
    "vae_decoder_from_state_dict": lambda: LL.vae_decoder_from_state_dict({}, LtxVaeConfig()),
    "vae_encoder_from_state_dict": lambda: LL.vae_encoder_from_state_dict({}, LtxVaeConfig()),
    "t5_from_hf_state_dict": lambda: PT5.t5_from_hf_state_dict({}, T5Config()),
    "transformer_from_jax": lambda: LCV.transformer_from_jax({}, LtxTransformerConfig()),
    "vae_decoder_from_jax": lambda: LCV.vae_decoder_from_jax({}, LtxVaeConfig()),
    "vae_encoder_from_jax": lambda: LCV.vae_encoder_from_jax({}, LtxVaeConfig()),
    "t5_from_jax": lambda: LCV.t5_from_jax({}, T5Config()),
    "unet_from_jax": lambda: SCV.unet_from_jax({}, PCFG.SvdUnetConfig()),
    "vae_from_jax": lambda: SCV.vae_from_jax({}, PCFG.SvdVaeConfig()),
    "clip_from_jax": lambda: SCV.clip_from_jax({}, PCFG.ClipEncoderConfig()),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_defaults_to_the_gpu_and_raises_without_one(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LOADERS[name]()
