"""The port's ``weight_format`` (its own copy of the JAX module) against the
JAX package's, key by key: every key of the three fixtures and of an
official-layout tiny checkpoint named from the port's modules.  Also the
port's diffusers -> official maps against ``scripts/officialize.py`` and as
``remap_key``'s inverse.  All comparisons are exact."""

import sys
from pathlib import Path

import pytest
import torch

from candle_video_tpu.models.ltx_video import weight_format as JW
from candle_video_tpu_torch.models.ltx_video import configs as C
from candle_video_tpu_torch.models.ltx_video import loader as L
from candle_video_tpu_torch.models.ltx_video import transformer as TF
from candle_video_tpu_torch.models.ltx_video import vae as V
from candle_video_tpu_torch.models.ltx_video import weight_format as PW

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import officialize  # noqa: E402

torch.set_num_threads(2)

FIXTURES = [ROOT / "fixtures" / f"{n}_parity.safetensors" for n in ("dit", "vae", "t5")]
TINY_TF = C.LtxTransformerConfig(in_channels=8, out_channels=8, num_attention_heads=2,
                                 attention_head_dim=12, cross_attention_dim=24, num_layers=2,
                                 caption_channels=16)
# the 0.9.8 decoder's layout (four up blocks: three upsampling ones and the
# tail) at narrow width
TINY_VAE = C.LtxVaeConfig(latent_channels=4, decoder_block_out_channels=(8, 16, 16),
                          decoder_layers_per_block=(1, 1, 1, 1), patch_size=2)


def _diffusers_keys():
    """The diffusers names of a tiny DiT and decoder of the port, and the
    encoder names of the VAE fixture."""
    dit = TF.empty_transformer(TINY_TF, "meta", torch.float32)
    dec = V.empty_decoder(TINY_VAE, "meta", torch.float32)
    enc = [k[len("weights."):] for k in L.list_tensor_names(str(FIXTURES[1]))
           if k.startswith("weights.encoder.")]
    return (sorted(L.transformer_state_dict(dit)), sorted(L.vae_decoder_state_dict(dec)),
            sorted(enc))


DIT_KEYS, DEC_KEYS, ENC_KEYS = _diffusers_keys()
OFFICIAL_KEYS = ([PW.officialize_transformer_key(k) for k in DIT_KEYS]
                 + [PW.officialize_vae_key(k) for k in DEC_KEYS + ENC_KEYS])
ALL_KEYS = sorted({k for f in FIXTURES for k in L.list_tensor_names(str(f))}
                  | set(OFFICIAL_KEYS))


@pytest.mark.parametrize("key", ALL_KEYS)
def test_remap_and_classifiers_equal_jax(key):
    assert PW.remap_key(key) == JW.remap_key(key)
    assert PW.is_transformer_key(key) == JW.is_transformer_key(key)
    assert PW.is_vae_key(key) == JW.is_vae_key(key)


@pytest.mark.parametrize("source", ["dit", "vae", "t5", "official"])
def test_split_unified_state_dict_equals_jax(source):
    """Both splits route every key to the same side under the same name and
    hand the values on untouched."""
    if source == "official":
        keys = OFFICIAL_KEYS
    else:
        keys = L.list_tensor_names(str(ROOT / "fixtures" / f"{source}_parity.safetensors"))
        keys = [k[len("weights."):] if k.startswith("weights.") else k for k in keys]
    sd = {k: object() for k in keys}
    got, want = PW.split_unified_state_dict(sd), JW.split_unified_state_dict(sd)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert all(g[k] is w[k] for k in g)
    if source == "official":
        assert sorted(got[0]) == DIT_KEYS
        assert sorted(got[1]) == sorted(DEC_KEYS + ENC_KEYS)


@pytest.mark.parametrize("key", DIT_KEYS + DEC_KEYS + ENC_KEYS)
def test_officialize_is_the_inverse_of_remap_key(key):
    if key in DIT_KEYS:
        off = PW.officialize_transformer_key(key)
        assert off == officialize.officialize_transformer_key(key)
        assert JW.remap_key(off)[len("model.diffusion_model."):] == key
    else:
        off = PW.officialize_vae_key(key)
        if key not in ("latents_mean", "latents_std"):  # the script leaves those to its callers
            assert off == officialize.officialize_vae_key(key)
        assert JW.remap_key(off)[len("vae."):] == key


def test_detect_format(tmp_path):
    f = tmp_path / "x.safetensors"
    L.save_safetensors({"a": torch.zeros(1)}, str(f))
    assert PW.detect_format(str(f)) == JW.detect_format(str(f)) == "official"
    assert PW.detect_format(str(tmp_path)) == JW.detect_format(str(tmp_path)) == "diffusers"
