"""Tensor parallelism of the PyTorch port (``--mesh tp=N``): ``make_mesh``'s
(dp, tp) grid, ``shard_transformer`` and the DiT forward with a tp group,
on the CPU, in f32, in gloo worlds of 2 and 4.

- The sharded forward (2 layers, a caption mask, an STG skip row, 3
  guidance rows with their own timesteps) at head dim 64 (8 heads), at
  head dim 128 (8 heads, K1's other lane grouping) and at 4 heads of 10
  (inner 40: the 4 RoPE pad lanes of ``dim % 6`` fill most of rank 0's
  shard): against JAX ``TF.forward`` under ``make_mesh(dp=1, tp=N)`` +
  ``shard_transformer_params`` on the virtual 8-device mesh (max-abs
  2e-3, the DiT envelope) and against the port unsharded (2e-5).
- ``generate()`` of a sharded model equals the unsharded one, and the
  CLI's tp run (``cli._run`` on a tp mesh) equals a run without a mesh,
  in a world of 2.
- The grid (rank r: dp r // tp, tp r % tp, and the groups' ranks) and the
  refusals: quantized linears, heads % tp, tp with sp.

Ranks run as in ``test_torch_ring.py``: subprocesses that import only the
port and assert it.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from candle_video_tpu_torch import cli as PCLI
from candle_video_tpu_torch.models.ltx_video import configs as PC
from candle_video_tpu_torch.models.ltx_video import convert as PCV
from candle_video_tpu_torch.models.ltx_video import pipeline as PP
from candle_video_tpu_torch.models.ltx_video import transformer as PTF
from candle_video_tpu_torch.ops.rope import rope_cos_sin
from candle_video_tpu_torch.parallel import Mesh, make_mesh, shard_transformer
from test_torch_ring import _MESHES, rank_main, run_world  # noqa: F401  (ranks import it)

torch.set_num_threads(2)

MODULE = "test_torch_tp"
BASE = dict(in_channels=8, out_channels=8, num_layers=2, caption_channels=16)
CFGS = {  # name: transformer config
    "hd64": dict(BASE, num_attention_heads=8, attention_head_dim=64, cross_attention_dim=512),
    "hd128": dict(BASE, num_attention_heads=8, attention_head_dim=128,
                  cross_attention_dim=1024),
    "pad": dict(BASE, num_attention_heads=4, attention_head_dim=10, cross_attention_dim=40),
}
# tiny CLI configs (the tp run needs heads divisible by 2)
CLI_TF = dict(BASE, num_attention_heads=2, attention_head_dim=64, cross_attention_dim=128,
              caption_channels=64)
VAE_CFG = dict(latent_channels=8, block_out_channels=(8, 16, 32),
               decoder_block_out_channels=(8, 16), spatiotemporal_scaling=(True, True),
               decoder_spatiotemporal_scaling=(True, True), layers_per_block=(1, 1, 2),
               decoder_layers_per_block=(1, 1, 1), patch_size=2,
               downsample_types=("spatiotemporal", "spatiotemporal"),
               decoder_upsample_residual=(True, True), decoder_upsample_factor=(2, 2),
               decoder_causal=False, spatial_compression_ratio=32,
               temporal_compression_ratio=4)
T5_CFG = dict(vocab_size=64, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)


def tp_mesh(tp, dp=1):
    """One mesh per (dp, tp) and rank process, kept where ``rank_main``
    drops it before the group is destroyed."""
    if ("tp", dp, tp) not in _MESHES:
        _MESHES["tp", dp, tp] = make_mesh(dp=dp, tp=tp)
    return _MESHES["tp", dp, tp]


def _setup(name, seed=0, f=2, h=2, w=3):
    """Numpy DiT tree from the JAX init, 3 guidance rows [uncond; cond;
    perturbed] at their own timesteps, a caption mask, an STG skip of
    layer 1 on the perturbed row, and the port's RoPE tables."""
    import jax

    from candle_video_tpu.models.ltx_video import transformer as JTF

    cfg = PC.LtxTransformerConfig(**CFGS[name])
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JTF.init_params(
        jax.random.PRNGKey(seed), JTF.LtxTransformerConfig(**CFGS[name]), dtype=np.float32))
    s = f * h * w
    mask = np.ones((3, 5), np.float32)
    mask[:, 3:] = 0.0
    skip = np.zeros((cfg.num_layers, 3), np.float32)
    skip[1, 2] = 1.0
    coords = PP.build_video_coords(f, h, w, 25.0)
    grid = coords[None] / np.asarray([cfg.rope_base_num_frames, cfg.rope_base_height,
                                      cfg.rope_base_width], np.float32)
    cos, sin = (t.numpy() for t in rope_cos_sin(torch.from_numpy(grid), cfg.inner_dim,
                                                cfg.rope_theta))
    return dict(tree=tree, hidden=rng.normal(size=(3, s, 8)).astype(np.float32),
                enc=rng.normal(size=(3, 5, 16)).astype(np.float32),
                t=np.asarray([981.0, 981.0, 420.0], np.float32), mask=mask, skip=skip,
                cos=cos, sin=sin)


def _port_forward(name, inp, mesh=None):
    model = PCV.transformer_from_jax(inp["tree"], PC.LtxTransformerConfig(**CFGS[name]),
                                     device="cpu")
    if mesh is not None:
        shard_transformer(model, mesh)
    with torch.no_grad():
        return model(*map(torch.from_numpy, (inp["hidden"], inp["enc"], inp["t"],
                                            inp["cos"], inp["sin"])),
                     encoder_attention_mask=torch.from_numpy(inp["mask"]),
                     skip_layer_mask=torch.from_numpy(inp["skip"])).numpy()


def _job_forward(name, inp):
    return _port_forward(name, inp, tp_mesh(dist.get_world_size()))


def _job_grid(dp, tp):
    """This rank's coordinates and its groups' ranks, or the refusal."""
    try:
        mesh = tp_mesh(tp, dp)
    except ValueError as e:
        return str(e)
    return dict(dp_rank=mesh.dp_rank, tp_rank=mesh.tp_rank, sp=mesh.sp, sp_group=mesh.sp_group,
                tp_ranks=dist.get_process_group_ranks(mesh.tp_group),
                dp_ranks=dist.get_process_group_ranks(mesh.dp_group))


def _tiny_pipe(tf_cfg):
    cfg = PC.LtxFullConfig(
        inference=PC.LtxInferenceConfig(guidance_scale=3.0, rescaling_scale=0.7,
                                        stg_scale=1.0, num_inference_steps=3,
                                        skip_block_list=(1,)),
        transformer=PC.LtxTransformerConfig(**tf_cfg), vae=PC.LtxVaeConfig(),
        scheduler=PC.FlowMatchEulerSchedulerConfig())
    model = PTF.init_random(cfg.transformer, "cpu", torch.float32,
                            generator=torch.Generator().manual_seed(0))
    return PP.LtxPipeline(config=cfg, transformer=model)


def _generate_kw():
    rng = np.random.default_rng(4)
    emb = torch.from_numpy((rng.normal(size=(1, 8, 16)) * 0.5).astype(np.float32))
    mask = torch.ones(1, 8)
    return dict(prompt_embeds=emb, prompt_attention_mask=mask,
                negative_prompt_embeds=torch.zeros_like(emb),
                negative_prompt_attention_mask=mask, height=64, width=96, num_frames=9,
                output_type="latent", seed=3)


def _job_generate():
    """generate() of a tp-sharded tiny pipeline (CFG + STG, 3 rows) and of
    the same pipeline unsharded."""
    cfg = dict(CFGS["hd64"])
    dense = PP.generate(_tiny_pipe(cfg), **_generate_kw()).numpy()
    pipe = _tiny_pipe(cfg)
    shard_transformer(pipe.transformer, tp_mesh(dist.get_world_size()))
    return dict(tp=PP.generate(pipe, **_generate_kw()).numpy(), dense=dense)


def cli_configs():
    return (PC.LtxFullConfig(
        inference=PC.LtxInferenceConfig(guidance_scale=2.0, num_inference_steps=2,
                                        stg_scale=1.0, rescaling_scale=0.7,
                                        skip_block_list=(1,)),
        transformer=PC.LtxTransformerConfig(**CLI_TF), vae=PC.LtxVaeConfig(**VAE_CFG),
        scheduler=PC.FlowMatchEulerSchedulerConfig(shift_terminal=0.1)),
        PC.T5Config(**T5_CFG))


CLI_ARGV = ["--device", "cpu", "--dtype", "float32", "--height", "64", "--width", "64",
            "--num-frames", "5", "--max-sequence-length", "16", "--seed", "3",
            "--output-type", "latent"]


def cli_latents(out_dir, mesh=None, interleave=1):
    """``cli._run`` at the tiny configs with embeddings from a file (a
    prompt and a negative one), on ``mesh`` (a tp or a pipeline mesh) or
    without one; returns the latents the run wrote, None where it wrote
    none."""
    from candle_video_tpu_torch.models.ltx_video import loader as PL

    cfg, t5cfg = cli_configs()
    out_dir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    emb = {k: torch.from_numpy((rng.normal(size=(1, 16, 64)) * 0.5).astype(np.float32))
           for k in ("prompt_embeds", "negative_prompt_embeds")}
    emb.update(prompt_attention_mask=torch.ones(1, 16),
               negative_prompt_attention_mask=torch.ones(1, 16))
    PL.save_safetensors(emb, str(out_dir / "emb.safetensors"))
    saved = PCLI.get_config_by_version, PCLI.t5_xxl
    PCLI.get_config_by_version, PCLI.t5_xxl = (lambda version: cfg), (lambda: t5cfg)
    try:
        args = PCLI.build_parser().parse_args(
            [*CLI_ARGV, "--output-dir", str(out_dir), "--embeddings-file",
             str(out_dir / "emb.safetensors")])
        assert PCLI._run(args, None, torch.device("cpu"), mesh, interleave) == 0
    finally:
        PCLI.get_config_by_version, PCLI.t5_xxl = saved
    path = out_dir / "latents.safetensors"
    return PL.load_safetensors(str(path))["latents"].numpy() if path.exists() else None


def _job_cli(out_dir):
    """The CLI's run without a mesh and on the tp mesh, each rank into its
    own directories (only the lead rank writes under a mesh)."""
    from pathlib import Path

    rank = dist.get_rank()
    dense = cli_latents(Path(out_dir) / f"dense{rank}")
    return dict(dense=dense, tp=cli_latents(Path(out_dir) / f"tp{rank}",
                                            tp_mesh(dist.get_world_size())))


JOBS = {"forward": _job_forward, "grid": _job_grid, "generate": _job_generate,
        "cli": _job_cli}


def _forward_jobs():
    return {f"forward_{name}": ("forward", dict(name=name, inp=_setup(name))) for name in CFGS}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp2")
    jobs = dict(_forward_jobs(), generate=("generate", {}), cli=("cli", dict(out_dir=str(tmp))),
                grid_1x2=("grid", dict(dp=1, tp=2)))
    return run_world(tmp, 2, jobs, module=MODULE)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    jobs = dict(_forward_jobs(), grid_2x2=("grid", dict(dp=2, tp=2)),
                grid_1x4=("grid", dict(dp=1, tp=4)), grid_3x1=("grid", dict(dp=3, tp=1)))
    return run_world(tmp_path_factory.mktemp("tp4"), 4, jobs, module=MODULE)


def _jax_forward(name, inp, tp):
    import jax
    import jax.numpy as jnp

    from candle_video_tpu.models.ltx_video import transformer as JTF
    from candle_video_tpu.parallel import make_mesh as jax_make_mesh
    from candle_video_tpu.parallel import shard_transformer_params

    mesh = jax_make_mesh(dp=1, tp=tp)
    with mesh:
        params = shard_transformer_params(jax.tree.map(jnp.asarray, inp["tree"]), mesh)
        return np.asarray(JTF.forward(
            params, JTF.LtxTransformerConfig(**CFGS[name]),
            *map(jnp.asarray, (inp["hidden"], inp["enc"], inp["t"], inp["cos"], inp["sin"])),
            encoder_attention_mask=jnp.asarray(inp["mask"]),
            skip_layer_mask=jnp.asarray(inp["skip"]), attn_impl="xla"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CFGS))
def test_tp_forward_matches_jax_and_the_port_unsharded(world2, world4, world, name):
    results = {2: world2, 4: world4}[world]
    inp = _setup(name)
    got = [r[f"forward_{name}"] for r in results]
    for other in got[1:]:  # every rank ends with the same replicated output
        np.testing.assert_array_equal(other, got[0])
    assert got[0].shape == (3, inp["hidden"].shape[1], 8)
    np.testing.assert_allclose(got[0], _jax_forward(name, inp, world), atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[0], _port_forward(name, inp), atol=2e-5, rtol=2e-5)


def test_generate_of_a_sharded_model_equals_generate(world2):
    for r in world2:
        got = r["generate"]
        assert got["tp"].shape == (1, 2 * 2 * 3, 8)
        np.testing.assert_allclose(got["tp"], got["dense"], atol=2e-5, rtol=2e-5)


def test_cli_tp_run_equals_the_run_without_a_mesh(world2):
    """``cli._run`` on a tp=2 mesh cuts the DiT (``shard_transformer``);
    only the lead rank writes, and its latents are the unsharded run's."""
    lead = world2[0]["cli"]
    assert world2[1]["cli"]["tp"] is None
    np.testing.assert_allclose(lead["tp"], lead["dense"], atol=2e-5, rtol=2e-5)


def test_make_mesh_lays_out_the_dp_tp_grid(world2, world4):
    """Rank r: dp r // tp, tp r % tp (the JAX ``devices.reshape(dp, tp)``),
    its tp row and its dp column; no ring on a tp mesh."""
    for world, results, (dp, tp) in ((2, world2, (1, 2)), (4, world4, (2, 2)),
                                     (4, world4, (1, 4))):
        for r, res in enumerate(results):
            got = res[f"grid_{dp}x{tp}"]
            assert (got["dp_rank"], got["tp_rank"], got["sp"], got["sp_group"]) == (
                r // tp, r % tp, 1, None)
            row = r // tp
            assert got["tp_ranks"] == [row * tp + j for j in range(tp)]
            assert got["dp_ranks"] == [i * tp + r % tp for i in range(dp)]
    assert all("world has 4" in res["grid_3x1"] for res in world4)


def _cpu_mesh(tp):
    return Mesh(dp=1, sp=1, dp_rank=0, sp_rank=0, sp_group=None, dp_group=None,
                device=torch.device("cpu"), tp=tp, tp_rank=0, tp_group=None)


@pytest.mark.parametrize("quantize", ["w8", "w4", "w8a8"])
def test_shard_transformer_refuses_quantized_linears(quantize):
    model = PTF.init_random(PC.LtxTransformerConfig(**CFGS["hd64"]), "cpu", torch.float32,
                            generator=torch.Generator().manual_seed(0))
    getattr(PTF, f"quantize_transformer_{quantize}")(model)
    with pytest.raises(ValueError, match="SINGLE-CHIP capacity path"):
        shard_transformer(model, _cpu_mesh(2))


def test_shard_transformer_refuses_heads_not_divisible_by_tp():
    model = PTF.init_random(PC.LtxTransformerConfig(**CFGS["pad"]), "cpu", torch.float32)
    with pytest.raises(ValueError, match="4 attention heads not divisible by tp=3"):
        shard_transformer(model, _cpu_mesh(3))
    assert shard_transformer(model, _cpu_mesh(1)) is model and model.tp is None


def test_make_mesh_refuses_tp_with_sp_as_jax_does():
    from candle_video_tpu.parallel.mesh import make_mesh as jax_make_mesh

    with pytest.raises(ValueError) as want:
        jax_make_mesh(tp=2, sp=2)
    with pytest.raises(ValueError, match="cannot be combined") as got:
        make_mesh(tp=2, sp=2)
    assert str(got.value) == str(want.value)


def test_shard_batch_and_replicate():
    from candle_video_tpu_torch.parallel import replicate, shard_batch

    x = torch.arange(16.0).reshape(4, 4)
    mesh = Mesh(dp=2, sp=1, dp_rank=1, sp_rank=0, sp_group=None, dp_group=None,
                device=torch.device("cpu"))
    assert torch.equal(shard_batch(x, mesh), x[2:])
    assert torch.equal(shard_batch(x, mesh, axis=1), x[:, 2:])
    assert replicate(x, mesh) is x
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        shard_batch(x[:3], mesh)
