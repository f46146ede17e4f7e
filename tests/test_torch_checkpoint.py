"""Checkpoints through the port's loaders (``models/ltx_video/loader.py``,
``t5.t5_from_hf_state_dict``) against the JAX package's, on the CPU.

- The safetensors reader and writer against the ``safetensors`` package,
  both ways, in every dtype the port reads; the header-only readers
  against the JAX ones.
- The repository's fixtures through the port's loaders against the
  fixtures' outputs and against JAX's forward on JAX's loaded parameters,
  at the JAX tests' own bounds (``tests/test_fixtures.py``): DiT 2e-3,
  decoder 5e-4, T5 2e-4 max-abs.
- The streaming W8/W4 loaders: payloads bit-equal to JAX's streaming
  loaders (f32 and bf16 files), forwards within the quant-tier tests'
  2e-3.
- An official single file written by the port's writer, split by
  ``split_unified_state_dict``, against the diffusers-layout load, in the
  port and in JAX (exact on the port's side, JAX's bounds across).
"""

import gc
import json
import mmap
import warnings
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from candle_video_tpu.models.ltx_video import loader as JL
from candle_video_tpu.models.ltx_video import t5 as JT5
from candle_video_tpu.models.ltx_video import transformer as JTF
from candle_video_tpu.models.ltx_video import vae as JV
from candle_video_tpu.models.ltx_video import weight_format as JW
from candle_video_tpu.ops import rope as JR
from candle_video_tpu_torch.models.ltx_video import configs as C
from candle_video_tpu_torch.models.ltx_video import loader as L
from candle_video_tpu_torch.models.ltx_video import t5 as PT5
from candle_video_tpu_torch.models.ltx_video import transformer as PTF
from candle_video_tpu_torch.models.ltx_video import weight_format as PW
from candle_video_tpu_torch.ops.quant_linear import Int4Linear, Int8Linear
from candle_video_tpu_torch.ops.rope import rope_cos_sin

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
DIT_FX = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=12,
              cross_attention_dim=24, num_layers=2, caption_channels=16)
VAE_FX = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(8, 16, 32),
              decoder_block_out_channels=(8, 16), spatiotemporal_scaling=(True, True),
              decoder_spatiotemporal_scaling=(True, True), layers_per_block=(1, 1, 2),
              decoder_layers_per_block=(1, 1, 1), patch_size=2, patch_size_t=1,
              downsample_types=("spatiotemporal", "spatiotemporal"),
              decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
              timestep_conditioning=True, decoder_causal=False, spatial_compression_ratio=8,
              temporal_compression_ratio=4)
T5_FX = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4)
# the quant-tier tests' narrow config with the 13B head width (K a multiple
# of qblock 128)
QCFG = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=128,
            cross_attention_dim=256, num_layers=2, caption_channels=64)


def _fixture(name):
    """(weights, the other tensors) of a fixture, read by the port."""
    fx = L.load_safetensors(str(FIXTURES / f"{name}_parity.safetensors"))
    weights = {k[len("weights."):]: v for k, v in fx.items() if k.startswith("weights.")}
    return weights, {k: v for k, v in fx.items() if not k.startswith("weights.")}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# reader and writer
# ---------------------------------------------------------------------------


def _sample(dtype, shape, gen):
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=gen,
                         dtype=torch.int64).to(dtype)


def _tensors(dtype):
    gen = torch.Generator().manual_seed(0)
    return {"a": _sample(dtype, (3, 5), gen), "b.scalar": _sample(dtype, (), gen),
            "c.empty": _sample(dtype, (0, 4), gen), "d": _sample(dtype, (7,), gen)}


@pytest.mark.parametrize("name", sorted(L._DTYPES))
def test_reader_reads_the_package_writer(tmp_path, name):
    from safetensors.torch import save_file

    want = _tensors(L._DTYPES[name])
    path = str(tmp_path / "x.safetensors")
    save_file(want, path, metadata={"k": "v"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no read-only buffer warning
        got = dict(L.load_safetensors(path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(L._DTYPES))
def test_package_reads_the_port_writer(tmp_path, name):
    from safetensors import safe_open

    want = _tensors(L._DTYPES[name])
    path = tmp_path / "x.safetensors"
    L.save_safetensors(want, str(path), metadata={"format": "pt", "n": 4})
    (n,) = np.frombuffer(path.read_bytes()[:8], "<u8")
    assert n % 8 == 0  # the header is padded to 8 bytes
    with safe_open(str(path), framework="pt") as f:
        assert f.metadata() == {"format": "pt", "n": "4"}
        got = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_views_share_the_mapping_and_never_write_the_file(tmp_path):
    path = tmp_path / "x.safetensors"
    L.save_safetensors({"a": torch.arange(6, dtype=torch.float32), "b": torch.ones(2)},
                       str(path))
    before = path.read_bytes()
    sd = L.load_safetensors(str(path))
    a1, a2 = sd["a"], sd["a"]
    assert a1.data_ptr() == a2.data_ptr()  # views of one mapping, no copy
    a1 += 1  # copy-on-write: the process's pages change, the file does not
    assert a2[0].item() == 1.0
    del sd, a2
    gc.collect()
    assert a1.sum().item() == 21.0  # the mapping outlives the file object
    assert path.read_bytes() == before


@pytest.mark.parametrize("fixture", ["dit", "vae", "t5"])
def test_header_readers_equal_jax_and_touch_no_data(tmp_path, monkeypatch, fixture):
    src = FIXTURES / f"{fixture}_parity.safetensors"
    names, info = JL.list_tensor_names(str(src)), JL.get_tensor_info(str(src))
    raw = src.read_bytes()
    (n,) = np.frombuffer(raw[:8], "<u8")
    cut = tmp_path / "header_only.safetensors"
    cut.write_bytes(raw[:8 + int(n)])  # the data is gone

    def no_mapping(*a, **k):
        raise AssertionError("a header read mapped the file")

    monkeypatch.setattr(mmap, "mmap", no_mapping)
    assert L.list_tensor_names(str(cut)) == names
    assert L.get_tensor_info(str(cut)) == info
    assert L.get_tensor_info(str(src)) == info


def test_load_model_config_and_sharded_directories(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"num_layers": 2}))
    assert L.load_model_config(str(tmp_path / "config.json")) == {"num_layers": 2}
    shards = tmp_path / "sharded"
    shards.mkdir()
    L.save_safetensors({"a": torch.ones(2)}, str(shards / "m-1.safetensors"))
    L.save_safetensors({"b": torch.zeros(3)}, str(shards / "m-2.safetensors"))
    (shards / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"a": "m-1.safetensors", "b": "m-2.safetensors"}}))
    got = L.load_sharded(str(shards))
    want = JL.load_sharded(str(shards))
    assert sorted(got) == sorted(want) == ["a", "b"]
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in got)
    (tmp_path / "empty").mkdir()
    with pytest.raises(L.LoaderError, match="no safetensors"):
        L.load_sharded(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------


def _dit_forward_port(model, io):
    grid = io["video_coords"].float() / torch.tensor([20.0, 2048.0, 2048.0])
    cos, sin = rope_cos_sin(grid, model.cfg.inner_dim)
    with torch.no_grad():
        return model(io["hidden_states"], io["encoder_hidden_states"], io["timestep"], cos,
                     sin, encoder_attention_mask=io["attention_mask"]).numpy()


def _dit_forward_jax(params, cfg, io):
    grid = JR.normalize_video_coords(jnp.asarray(io["video_coords"].numpy()), 20, 2048, 2048)
    cos, sin = JR.rope_cos_sin(grid, cfg.inner_dim)
    return np.asarray(JTF.forward(params, cfg, jnp.asarray(io["hidden_states"].numpy()),
                                  jnp.asarray(io["encoder_hidden_states"].numpy()),
                                  jnp.asarray(io["timestep"].numpy()), cos, sin,
                                  encoder_attention_mask=jnp.asarray(
                                      io["attention_mask"].numpy()),
                                  attn_impl="xla"))


def test_dit_fixture_through_the_port_loader():
    weights, io = _fixture("dit")
    model = L.transformer_from_state_dict(weights, C.LtxTransformerConfig(**DIT_FX), "cpu",
                                          torch.float32)
    got = _dit_forward_port(model, io)
    assert np.abs(got - io["output"].numpy()).max() < 2e-3
    jcfg = JTF.LtxTransformerConfig(**DIT_FX)
    want = _dit_forward_jax(JL.transformer_params_from_state_dict(_np(weights), jcfg,
                                                                  jnp.float32), jcfg, io)
    assert np.abs(got - want).max() < 2e-3


def test_vae_decoder_fixture_through_the_port_loader():
    weights, io = _fixture("vae")
    dec = L.vae_decoder_from_state_dict(weights, C.LtxVaeConfig(**VAE_FX), "cpu",
                                        torch.float32)
    with torch.no_grad():
        got = dec(io["dec_input"], io["dec_temb"]).numpy()
    np.testing.assert_allclose(got, io["dec_output"].numpy(), atol=5e-4)
    params = JL.vae_params_from_state_dict(_np(weights), jnp.float32)
    want = np.asarray(JV.decoder_forward(params["decoder"], JV.LtxVaeConfig(**VAE_FX),
                                         jnp.asarray(io["dec_input"].numpy()),
                                         jnp.asarray(io["dec_temb"].numpy())))
    np.testing.assert_allclose(got, want, atol=5e-4)
    # no statistics in the file: identity denormalisation
    assert not dec.latents_mean.any() and bool((dec.latents_std == 1).all())
    assert dec.timestep_scale_multiplier.item() == weights[
        "decoder.timestep_scale_multiplier"].item()


def test_t5_fixture_through_the_port_loader():
    weights, io = _fixture("t5")
    enc = PT5.t5_from_hf_state_dict(weights, C.T5Config(**T5_FX), "cpu", torch.float32)
    with torch.no_grad():
        got = enc(io["input_ids"].long()).numpy()
    assert np.abs(got - io["output"].numpy()).max() < 2e-4
    jcfg = JT5.T5Config(**T5_FX)
    params = JT5.params_from_hf_state_dict(_np(weights), jcfg, jnp.float32)
    want = np.asarray(JT5.forward(params, jcfg, jnp.asarray(io["input_ids"].numpy())))
    assert np.abs(got - want).max() < 2e-4


def test_t5_reads_the_embedding_under_either_name_and_a_prefix():
    weights, io = _fixture("t5")
    cfg = C.T5Config(**T5_FX)
    renamed = {("text_encoder." + (k if k != "shared.weight" else
                                   "encoder.embed_tokens.weight")): v
               for k, v in weights.items()}
    a = PT5.t5_from_hf_state_dict(weights, cfg, "cpu", torch.float32)
    b = PT5.t5_from_hf_state_dict(renamed, cfg, "cpu", torch.float32, prefix="text_encoder.")
    ids = io["input_ids"].long()
    with torch.no_grad():
        assert torch.equal(a(ids), b(ids))


# ---------------------------------------------------------------------------
# streaming W8 / W4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_file(tmp_path_factory):
    """A diffusers-layout f32 DiT file of ``QCFG`` with non-zero biases, and
    its bf16 twin."""
    gen = torch.Generator().manual_seed(4)
    model = PTF.init_random(C.LtxTransformerConfig(**QCFG), "cpu", torch.float32, gen)
    sd = L.transformer_state_dict(model)
    sd = {k: v + torch.randn(v.shape, generator=gen) * 0.02 if k.endswith(".bias") else v
          for k, v in sd.items()}
    root = tmp_path_factory.mktemp("dense")
    paths = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        paths[name] = str(root / f"dit_{name}.safetensors")
        L.save_safetensors({k: v.to(dtype) for k, v in sd.items()}, paths[name])
    return paths


def _jax_sd(path):
    """The JAX loaders' numpy state dict of a port-written file (bf16 as
    ml_dtypes, which the ``safetensors`` numpy reader does not give)."""
    out = {}
    for k, v in L.load_safetensors(path).items():
        out[k] = (v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                  if v.dtype == torch.bfloat16 else v.numpy())
    return out


_TIERS = {
    "w8": (L.transformer_w8_from_state_dict, JL.transformer_params_w8_from_state_dict,
           {"w8": "w_q", "w8_scale": "s", "bias": "bias"}, Int8Linear),
    "w4": (L.transformer_w4_from_state_dict, JL.transformer_params_w4_from_state_dict,
           {"w4": "w4", "w4_scale": "w4_scale", "w4_min": "w4_min", "bias": "bias"},
           Int4Linear),
}


@pytest.mark.parametrize("file_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tier", ["w8", "w4"])
def test_streaming_payloads_equal_jax(dense_file, tier, file_dtype):
    load, jload, names, mod_type = _TIERS[tier]
    model = load(L.load_safetensors(dense_file[file_dtype]), C.LtxTransformerConfig(**QCFG),
                 "cpu", torch.float32)
    tree = jload(_jax_sd(dense_file[file_dtype]), JTF.LtxTransformerConfig(**QCFG),
                 jnp.float32)
    for i, blk in enumerate(model.blocks):
        for group, name in PTF.QUANTIZED_LINEARS:
            lin = getattr(getattr(blk, group), name)
            assert isinstance(lin, mod_type)
            leaf = tree["blocks"][group][name]
            assert set(leaf) == set(names)
            for jname, pname in names.items():
                got, want = getattr(lin, pname), np.asarray(leaf[jname][i])
                if want.dtype == ml_dtypes.bfloat16:
                    assert got.dtype == torch.bfloat16
                    got, want = got.float(), want.astype(np.float32)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{i}.{group}.{name}."
                                              f"{jname}")


@pytest.mark.parametrize("tier", ["w8", "w4"])
def test_streaming_equals_quantizing_the_dense_load(dense_file, tier):
    """At f32 the streaming loaders give ``quantize_transformer_w8`` /
    ``_w4``'s payloads of the dense load, and so its forward exactly; the
    forward agrees with JAX's on its streaming tree within 2e-3."""
    load, jload = _TIERS[tier][:2]
    cfg = C.LtxTransformerConfig(**QCFG)
    sd = L.load_safetensors(dense_file["f32"])
    streamed = load(sd, cfg, "cpu", torch.float32)
    dense = L.transformer_from_state_dict(sd, cfg, "cpu", torch.float32)
    quantized = (PTF.quantize_transformer_w8(dense) if tier == "w8"
                 else PTF.quantize_transformer_w4(dense))
    rng = np.random.default_rng(5)
    b, s, kv = 1, 1040, 16  # the large-M linears on the transient route, k/v on the kernel's
    x = rng.normal(size=(b, s, 8)).astype(np.float32)
    enc = rng.normal(size=(b, kv, 64)).astype(np.float32)
    t = np.array([700.0], np.float32)
    grid = rng.uniform(size=(1, s, 3)).astype(np.float32)
    cos, sin = JR.rope_cos_sin(jnp.asarray(grid), 256)
    args = [torch.from_numpy(a) for a in (x, enc, t, np.array(cos), np.array(sin))]
    with torch.no_grad():
        got = streamed(*args).numpy()
        assert np.array_equal(got, quantized(*args).numpy())
    tree = jload(_jax_sd(dense_file["f32"]), JTF.LtxTransformerConfig(**QCFG), jnp.float32)
    want = JTF.forward(tree, JTF.LtxTransformerConfig(**QCFG), jnp.asarray(x),
                       jnp.asarray(enc), jnp.asarray(t), cos, sin, attn_impl="xla")
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=0)


def test_streaming_loaders_never_build_the_dense_block_tree(dense_file, monkeypatch):
    """No ``nn.Linear`` of the block stack is ever allocated off ``meta``."""
    seen = []
    init = torch.nn.Linear.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        seen.append(self.weight.device.type)

    monkeypatch.setattr(torch.nn.Linear, "__init__", spy)
    L.transformer_w8_from_state_dict(L.load_safetensors(dense_file["f32"]),
                                     C.LtxTransformerConfig(**QCFG), "cpu", torch.float32)
    assert set(seen) == {"meta"}


# ---------------------------------------------------------------------------
# the official single file
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unified_file(tmp_path_factory):
    """The DiT and VAE fixtures' weights (encoder included) plus latent
    statistics, under official names, written by the port's writer."""
    dit, _ = _fixture("dit")
    vae, _ = _fixture("vae")
    vae = dict(vae, latents_mean=torch.linspace(-0.1, 0.1, 4),
               latents_std=torch.linspace(0.9, 1.1, 4))
    unified = {PW.officialize_transformer_key(k): v for k, v in dit.items()}
    unified.update({PW.officialize_vae_key(k): v for k, v in vae.items()})
    path = str(tmp_path_factory.mktemp("unified") / "ltxv-tiny.safetensors")
    L.save_safetensors(unified, path)
    return path, dit, vae


def test_unified_file_loads_as_the_diffusers_layout(unified_file):
    path, dit_sd, vae_sd = unified_file
    assert PW.detect_format(path) == "official"
    tsd, vsd = PW.split_unified_state_dict(L.load_safetensors(path))
    tcfg, vcfg = C.LtxTransformerConfig(**DIT_FX), C.LtxVaeConfig(**VAE_FX)
    _, io = _fixture("dit")
    got = _dit_forward_port(L.transformer_from_state_dict(tsd, tcfg, "cpu", torch.float32), io)
    want = _dit_forward_port(L.transformer_from_state_dict(dit_sd, tcfg, "cpu", torch.float32),
                             io)
    assert np.array_equal(got, want)
    _, vio = _fixture("vae")
    dec = L.vae_decoder_from_state_dict(vsd, vcfg, "cpu", torch.float32)
    ref = L.vae_decoder_from_state_dict(vae_sd, vcfg, "cpu", torch.float32)
    assert torch.equal(dec.latents_std, torch.linspace(0.9, 1.1, 4))
    with torch.no_grad():
        assert torch.equal(dec(vio["dec_input"], vio["dec_temb"]),
                           ref(vio["dec_input"], vio["dec_temb"]))
    # JAX reads the port's file (through the safetensors package) the same way
    jt, jv = JW.split_unified_state_dict(JL.load_safetensors(path))
    jcfg = JTF.LtxTransformerConfig(**DIT_FX)
    jax_out = _dit_forward_jax(JL.transformer_params_from_state_dict(jt, jcfg, jnp.float32),
                               jcfg, io)
    assert np.abs(got - jax_out).max() < 2e-3
    jparams = JL.vae_params_from_state_dict(jv, jnp.float32)
    np.testing.assert_array_equal(np.asarray(jparams["latents_std"]), dec.latents_std.numpy())
    jdec = np.asarray(JV.decoder_forward(jparams["decoder"], JV.LtxVaeConfig(**VAE_FX),
                                         jnp.asarray(vio["dec_input"].numpy()),
                                         jnp.asarray(vio["dec_temb"].numpy())))
    with torch.no_grad():
        np.testing.assert_allclose(dec(vio["dec_input"], vio["dec_temb"]).numpy(), jdec,
                                   atol=5e-4)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loader", ["dense", "w8", "w4"])
def test_a_missing_dit_tensor_is_named(dense_file, loader):
    sd = dict(L.load_safetensors(dense_file["f32"]))
    for gone in ("transformer_blocks.1.attn1.to_k.weight", "transformer_blocks.0.ff.net.2.bias",
                 "time_embed.linear.weight", "transformer_blocks.1.attn2.norm_q.weight"):
        cut = {k: v for k, v in sd.items() if k != gone}
        load = {"dense": L.transformer_from_state_dict, "w8": L.transformer_w8_from_state_dict,
                "w4": L.transformer_w4_from_state_dict}[loader]
        with pytest.raises(L.LoaderError, match=f"missing tensor {gone}"):
            load(cut, C.LtxTransformerConfig(**QCFG), "cpu", torch.float32)


@pytest.mark.parametrize("loader", ["dense", "w8"])
def test_a_bias_the_config_does_not_build_raises(dense_file, loader):
    cfg = C.LtxTransformerConfig(**QCFG, attention_bias=False)
    load = {"dense": L.transformer_from_state_dict,
            "w8": L.transformer_w8_from_state_dict}[loader]
    with pytest.raises(L.LoaderError, match="without a bias"):
        load(L.load_safetensors(dense_file["f32"]), cfg, "cpu", torch.float32)


def test_vae_and_t5_errors():
    vae, _ = _fixture("vae")
    cfg = C.LtxVaeConfig(**VAE_FX)
    with pytest.raises(L.LoaderError, match="missing tensor decoder.conv_out.conv.bias"):
        L.vae_decoder_from_state_dict({k: v for k, v in vae.items()
                                       if k != "decoder.conv_out.conv.bias"}, cfg, "cpu")
    with pytest.raises(L.LoaderError, match="the file's decoder has"):
        L.vae_decoder_from_state_dict(
            vae, C.LtxVaeConfig(**dict(VAE_FX, decoder_layers_per_block=(2, 1, 1))), "cpu")
    extra = dict(vae, **{"decoder.up_blocks.0.resnets.0.conv_shortcut.conv.weight":
                         torch.zeros(1)})
    with pytest.raises(L.LoaderError, match="no place for"):
        L.vae_decoder_from_state_dict(extra, cfg, "cpu")
    noise = dict(vae, **{"decoder.up_blocks.0.resnets.0.per_channel_scale1": torch.ones(8),
                         "decoder.mid_block.resnets.0.per_channel_scale2.weight":
                         torch.ones(16)})
    with pytest.raises(L.LoaderError, match="no place for"):  # the config injects no noise
        L.vae_decoder_from_state_dict(noise, cfg, "cpu")
    t5, _ = _fixture("t5")
    gone = "encoder.block.2.layer.1.DenseReluDense.wo.weight"
    with pytest.raises(L.LoaderError, match=f"missing tensor {gone}"):
        PT5.t5_from_hf_state_dict({k: v for k, v in t5.items() if k != gone},
                                  C.T5Config(**T5_FX), "cpu")


def test_name_table_covers_every_tensor_once():
    """The writer's names are the loader's: a module written by
    ``transformer_state_dict`` / ``vae_decoder_state_dict`` loads back to
    the same tensors, and no two of its tensors share a checkpoint name."""
    gen = torch.Generator().manual_seed(1)
    dit = PTF.init_random(C.LtxTransformerConfig(**DIT_FX), "cpu", torch.float32, gen)
    sd = L.transformer_state_dict(dit)
    assert len(sd) == len(dit.state_dict())
    back = L.transformer_from_state_dict(sd, dit.cfg, "cpu", torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(dit.state_dict().values(),
                                                 back.state_dict().values()))
    vae, _ = _fixture("vae")
    dec = L.vae_decoder_from_state_dict(vae, C.LtxVaeConfig(**VAE_FX), "cpu", torch.float32)
    assert {k for k in L.vae_decoder_state_dict(dec)} == {
        k for k in vae if k.startswith("decoder.")} | {"latents_mean", "latents_std"}

