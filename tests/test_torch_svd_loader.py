"""The port's safetensors reader (``models/ltx_video/loader.py``, which
reads the format itself) against the ``safetensors`` package and the JAX
package's ``load_sharded``, and a diffusers-layout SVD checkpoint directory
loaded through it into the port's modules.

Files are written with the ``safetensors`` package; the tests skip where it
is not installed."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_svd  # noqa: E402
import torch_svd_vae as tvv  # noqa: E402

from candle_video_tpu.models.ltx_video import loader as JL  # noqa: E402
from candle_video_tpu_torch.models.ltx_video import loader as PLD  # noqa: E402
from candle_video_tpu_torch.models.svd import configs as PCFG  # noqa: E402
from candle_video_tpu_torch.models.svd import loader as PL  # noqa: E402
from candle_video_tpu_torch.models.svd import vae as PV  # noqa: E402

st = pytest.importorskip("safetensors.torch")

torch.set_num_threads(2)


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32.weight": torch.randn(3, 5, generator=g),
        "f16.weight": torch.randn(7, 2, generator=g).half(),
        "bf16.weight": torch.randn(4, 6, generator=g).bfloat16(),
        "scalar": torch.randn((), generator=g),
        "ints": torch.arange(10, dtype=torch.int64).reshape(2, 5),
        "empty": torch.zeros(0, 3),
    }


def _equal_to_jax(got: dict, want: dict):
    assert set(got) == set(want)
    for name, arr in want.items():
        arr = np.asarray(arr)
        t = got[name]
        assert tuple(t.shape) == arr.shape, name
        if arr.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
        else:
            assert t.numpy().dtype == arr.dtype, name
            np.testing.assert_array_equal(t.numpy(), arr)


def test_load_safetensors_matches_the_package_and_jax(tmp_path):
    tensors = _tensors()
    path = tmp_path / "model.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    got = PLD.load_safetensors(str(path))
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    want = JL.load_safetensors(str(path))
    _equal_to_jax({k: v for k, v in got.items() if k in want}, want)


def test_load_sharded_with_an_index_matches_jax(tmp_path):
    shards = {"model-00001-of-00002.safetensors": _tensors(1),
              "model-00002-of-00002.safetensors": {f"b.{k}": v for k, v in _tensors(2).items()}}
    weight_map = {}
    for fname, tensors in shards.items():
        st.save_file(tensors, str(tmp_path / fname))
        weight_map.update(dict.fromkeys(tensors, fname))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    (tmp_path / "stray.safetensors").write_bytes(b"not read: the index names the shards")
    got = PLD.load_sharded(str(tmp_path))
    assert set(got) == set(weight_map)
    want = JL.load_sharded(str(tmp_path))
    _equal_to_jax({k: v for k, v in got.items() if k in want}, want)


def test_load_sharded_falls_back_to_every_file(tmp_path):
    st.save_file({"a": torch.ones(2)}, str(tmp_path / "diffusion_pytorch_model.safetensors"))
    st.save_file({"b": torch.zeros(3).bfloat16()}, str(tmp_path / "extra.safetensors"))
    got = PLD.load_sharded(str(tmp_path))
    assert set(got) == {"a", "b"} and got["b"].dtype == torch.bfloat16
    (tmp_path / "empty").mkdir()
    with pytest.raises(PLD.LoaderError, match="no safetensors"):
        PLD.load_sharded(str(tmp_path / "empty"))


def test_svd_checkpoint_dir_loads_into_the_port(tmp_path):
    """The torch mirrors' UNet and VAE saved as diffusers-layout bf16
    safetensors, read back by the port: the modules hold the saved values."""
    torch.manual_seed(0)
    unet = torch_svd.UNetSpatioTemporal(in_channels=8, out_channels=4,
                                        block_out_channels=(32, 64), layers_per_block=1,
                                        cross_dim=16, heads=(2, 4), addition_time_embed_dim=8)
    vae = tvv.AutoencoderKLTemporalDecoder(boc=(32, 64), latent=4, layers=1)
    for sub, model in (("unet", unet), ("vae", vae)):
        (tmp_path / sub).mkdir()
        sd = {k: v.bfloat16().contiguous() for k, v in model.state_dict().items()}
        st.save_file(sd, str(tmp_path / sub / "diffusion_pytorch_model.safetensors"))
    ucfg = PCFG.SvdUnetConfig(in_channels=8, out_channels=4, block_out_channels=(32, 64),
                              layers_per_block=1, cross_attention_dim=16,
                              num_attention_heads=(2, 4), addition_time_embed_dim=8,
                              projection_class_embeddings_input_dim=24)
    mine = PL.unet_params_from_state_dict(PLD.load_sharded(str(tmp_path / "unet")), ucfg,
                                          device="cpu", dtype=torch.bfloat16)
    mine_vae = PV.vae_params_from_state_dict(PLD.load_sharded(str(tmp_path / "vae")),
                                             PCFG.SvdVaeConfig(block_out_channels=(32, 64),
                                                               layers_per_block=1),
                                             device="cpu", dtype=torch.float32)
    for name, t in unet.state_dict().items():
        assert torch.equal(mine.state_dict()[name], t.bfloat16()), name
    for name, t in vae.state_dict().items():
        assert torch.equal(mine_vae.state_dict()[name], t.bfloat16().float()), name
    with pytest.raises(KeyError, match="mismatch"):
        PL.unet_params_from_state_dict({"conv_in.weight": torch.zeros(1)}, ucfg, "cpu")
