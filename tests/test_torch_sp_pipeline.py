"""The sequence-parallel denoise path of the PyTorch port (``--mesh sp=N``):
``parallel.denoise_loop_sp`` and ``generate(sp_mesh=...)`` on the CPU, in
f32, in gloo worlds of 4 ranks and of 1.

- ``denoise_loop_sp`` at (dp, sp) = (1, 4) and (2, 2) with num_conds 2
  (CFG with guidance rescale), and with an STG skip row at num_conds 3:
  against JAX ``denoise_loop_sp`` on the same numpy parameters (the DiT
  envelope, max-abs < 2e-3) and against the port's own ``denoise_loop``
  (2e-5, as the JAX package's own SP test).
- With strong guidance the rescale's std must be the whole sequence's: the
  port's ring loop equals its single-process loop there too.
- ``generate(sp_mesh=make_mesh(sp=1))`` equals ``generate()`` in a ring of
  one; the refusals (stochastic sampling, ``step_callback``, S % sp,
  B % dp, tp with sp, pp with sp, ``--mesh`` with ``--dit-int4``).

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
from candle_video_tpu_torch.models.ltx_video import scheduler as PS
from candle_video_tpu_torch.models.ltx_video import transformer as PTF
from candle_video_tpu_torch.ops.rope import rope_cos_sin
from candle_video_tpu_torch.parallel import Mesh, denoise_loop_sp, make_mesh
from test_torch_ring import mesh_of, rank_main, run_world  # noqa: F401  (ranks import it)

torch.set_num_threads(2)

MODULE = "test_torch_sp_pipeline"
TF_CFG = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=64,
              cross_attention_dim=128, num_layers=2, caption_channels=16)
SIGMAS = np.asarray([1.0, 0.7, 0.3, 0.0], np.float32)


def _setup(seed=0, b=2, f=2, h=2, w=4, num_conds=2, enc_scale=0.02):
    """The JAX SP test's inputs at head dim 64: numpy DiT tree, latents,
    guidance rows [uncond; cond; perturbed], RoPE tables, skip mask."""
    import jax

    from candle_video_tpu.models.ltx_video import transformer as JTF

    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JTF.init_params(
        jax.random.PRNGKey(seed), JTF.LtxTransformerConfig(**TF_CFG), dtype=np.float32))
    s = f * h * w
    hidden = rng.normal(size=(b, s, 8)).astype(np.float32)
    enc = (rng.normal(size=(b, 8, 16)) * enc_scale).astype(np.float32)
    enc_rows = np.concatenate([np.zeros_like(enc)] + [enc] * (num_conds - 1))
    coords = PP.build_video_coords(f, h, w, 25.0)
    cfg = PC.LtxTransformerConfig(**TF_CFG)
    grid = coords[None] / np.asarray([cfg.rope_base_num_frames, cfg.rope_base_height,
                                      cfg.rope_base_width], np.float32)
    cos, sin = (t.numpy() for t in rope_cos_sin(torch.from_numpy(grid), cfg.inner_dim,
                                                cfg.rope_theta))
    return dict(tree=tree, hidden=hidden, enc=enc_rows,
                mask=np.ones((num_conds * b, 8), np.float32), cos=cos, sin=sin,
                skip=np.zeros((TF_CFG["num_layers"], num_conds * b), np.float32))


def _port_loop(inp, guidance, mesh=None):
    """The port's loop, single-process or on ``mesh``, on ``_setup``'s inputs."""
    model = PCV.transformer_from_jax(inp["tree"], PC.LtxTransformerConfig(**TF_CFG), device="cpu")
    schedule = PS.Schedule(sigmas=SIGMAS, timesteps=SIGMAS[:-1] * 1000.0,
                           num_inference_steps=3)
    skip = torch.from_numpy(inp["skip"]) if inp["skip"].any() else None
    args = (model, *map(torch.from_numpy, (inp["hidden"], inp["enc"], inp["mask"])), schedule,
            torch.from_numpy(inp["cos"]), torch.from_numpy(inp["sin"]))
    kw = dict(skip_layer_mask=skip, **guidance)
    with torch.no_grad():
        if mesh is None:
            return PP.denoise_loop(*args, **kw).numpy()
        return denoise_loop_sp(*args, mesh=mesh, **kw).numpy()


def _job_denoise(inp, guidance, dp, sp):
    return _port_loop(inp, guidance, mesh_of(dp, sp))


def _job_make_mesh(dp, sp):
    """The refusal's message (dp x sp is not the world's size)."""
    try:
        make_mesh(dp=dp, sp=sp)
    except ValueError as e:
        return str(e)
    return None


def _tiny_pipe(**inference):
    cfg = PC.LtxFullConfig(
        inference=PC.LtxInferenceConfig(guidance_scale=3.0, rescaling_scale=0.7,
                                        stg_scale=0.0, num_inference_steps=3,
                                        skip_block_list=(), **inference),
        transformer=PC.LtxTransformerConfig(**TF_CFG), vae=PC.LtxVaeConfig(),
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
                negative_prompt_attention_mask=mask, height=64, width=128, num_frames=9,
                output_type="latent", seed=3)


def _job_generate():
    """generate() with and without the ring of one, and its stage times."""
    pipe, kw = _tiny_pipe(), _generate_kw()
    times = {}
    sp = PP.generate(pipe, sp_mesh=mesh_of(1, 1), stage_times=times, **kw).numpy()
    return dict(sp=sp, dense=PP.generate(pipe, **kw).numpy(),
                steps=len(times["denoise_steps"]))


JOBS = {"denoise": _job_denoise, "make_mesh": _job_make_mesh, "generate": _job_generate}

CFG2 = dict(num_conds=2, guidance_scale=3.0, guidance_rescale=0.7, stg_scale=0.0)
STG3 = dict(num_conds=3, guidance_scale=3.0, guidance_rescale=0.0, stg_scale=1.5)
CASES = {  # name: (setup keywords, guidance, (dp, sp))
    "cfg_dp1_sp4": (dict(), CFG2, (1, 4)),
    "cfg_dp2_sp2": (dict(), CFG2, (2, 2)),
    "stg_dp1_sp4": (dict(b=1, num_conds=3), STG3, (1, 4)),
    # captions far apart: the rescale's std ratio differs shard by shard
    "strong_cfg_dp1_sp4": (dict(enc_scale=3.0), CFG2, (1, 4)),
}


def _inputs(name):
    setup_kw, guidance, _ = CASES[name]
    inp = _setup(**setup_kw)
    if name.startswith("stg"):
        inp["skip"][1, 2] = 1.0  # skip layer 1 on the perturbed row
    return inp, guidance


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    jobs = {}
    for name, (_, _, (dp, sp)) in CASES.items():
        inp, guidance = _inputs(name)
        jobs[name] = ("denoise", dict(inp=inp, guidance=guidance, dp=dp, sp=sp))
    jobs["mesh_3x1"] = ("make_mesh", dict(dp=3, sp=1))
    return run_world(tmp_path_factory.mktemp("sp4"), 4, jobs, module=MODULE)


@pytest.mark.parametrize("name", [n for n in CASES if not n.startswith("strong")])
def test_denoise_loop_sp_matches_jax_and_the_port_loop(world4, name):
    import jax
    import jax.numpy as jnp

    from candle_video_tpu.models.ltx_video import transformer as JTF
    from candle_video_tpu.parallel import denoise_loop_sp as jax_loop_sp
    from candle_video_tpu.parallel import make_mesh as jax_make_mesh

    inp, guidance = _inputs(name)
    dp, sp = CASES[name][2]
    got = [r[name] for r in world4]
    for other in got[1:]:  # every rank returns the same gathered latents
        np.testing.assert_array_equal(other, got[0])
    assert got[0].shape == inp["hidden"].shape

    want = np.asarray(jax_loop_sp(
        jax.tree.map(jnp.asarray, inp["tree"]), JTF.LtxTransformerConfig(**TF_CFG),
        *map(jnp.asarray, (inp["hidden"], inp["enc"], inp["mask"], SIGMAS,
                           SIGMAS[:-1] * 1000.0, inp["cos"], inp["sin"])),
        guidance["guidance_scale"], guidance["guidance_rescale"], guidance["stg_scale"],
        jnp.asarray(inp["skip"]), mesh=jax_make_mesh(dp=dp, sp=sp),
        num_conds=guidance["num_conds"], attn_impl="xla", use_skip=bool(inp["skip"].any())))
    np.testing.assert_allclose(got[0], want, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[0], _port_loop(inp, guidance), atol=2e-5, rtol=2e-5)


def test_denoise_loop_sp_rescale_takes_the_whole_sequence(world4):
    """Far-apart captions make the CFG rescale's std ratio differ from shard
    to shard; the port reduces it over the ring, so it still equals the
    single-process loop."""
    inp, guidance = _inputs("strong_cfg_dp1_sp4")
    got = world4[0]["strong_cfg_dp1_sp4"]
    np.testing.assert_allclose(got, _port_loop(inp, guidance), atol=2e-5, rtol=2e-5)


def test_make_mesh_refuses_a_grid_that_is_not_the_world(world4):
    for r in world4:
        assert r["mesh_3x1"] is not None and "world has 4" in r["mesh_3x1"]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("sp1"), 1, {"generate": ("generate", {})},
                     module=MODULE)[0]["generate"]


def test_generate_sp_ring_of_one_equals_generate(world1):
    assert world1["sp"].shape == world1["dense"].shape == (1, 2 * 2 * 4, 8)
    np.testing.assert_allclose(world1["sp"], world1["dense"], atol=2e-5, rtol=2e-5)
    assert world1["steps"] == 3  # stage_times keeps its per-step list


def _cpu_mesh(dp=1, sp=1):
    return Mesh(dp=dp, sp=sp, dp_rank=0, sp_rank=0, sp_group=None, dp_group=None,
                device=torch.device("cpu"))


def test_generate_sp_refusals():
    kw = _generate_kw()
    with pytest.raises(ValueError, match="step_callback"):
        PP.generate(_tiny_pipe(), sp_mesh=_cpu_mesh(), step_callback=lambda *a: None, **kw)
    with pytest.raises(ValueError, match="stochastic"):
        PP.generate(_tiny_pipe(stochastic_sampling=True), sp_mesh=_cpu_mesh(), **kw)


def test_denoise_loop_sp_refuses_indivisible_shapes():
    inp = _setup()
    model = PCV.transformer_from_jax(inp["tree"], PC.LtxTransformerConfig(**TF_CFG), device="cpu")
    schedule = PS.Schedule(sigmas=SIGMAS, timesteps=SIGMAS[:-1] * 1000.0,
                           num_inference_steps=3)
    args = (model, *map(torch.from_numpy, (inp["hidden"], inp["enc"], inp["mask"])), schedule,
            torch.from_numpy(inp["cos"]), torch.from_numpy(inp["sin"]))
    with pytest.raises(ValueError, match="not divisible by sp=3"):
        denoise_loop_sp(*args, mesh=_cpu_mesh(sp=3), num_conds=2)
    with pytest.raises(ValueError, match="batch 2 not divisible by dp=4"):
        denoise_loop_sp(*args, mesh=_cpu_mesh(dp=4), num_conds=2)


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "sp=2,tp=2"], "cannot be combined"),
    (["--mesh", "sp=2,pp=2"], "at most one of pp and sp"),
    (["--mesh", "sp=2", "--dit-int4"], "does not compose with --mesh"),
    (["--mesh", "sp=2", "--dit-int8"], "does not compose with --mesh"),
    (["--mesh", "sp=2,dp=2"], "one video"),
    (["--mesh", "sp=2", "--progress"], "--progress"),
    (["--mesh", "sp=two"], "axis=N"),
    (["--mesh", "sp=2", "--device", "cpu"], "torchrun --nproc_per_node=2"),
], ids=["tp", "pp", "int4", "int8", "dp", "progress", "malformed", "no_torchrun"])
def test_cli_mesh_refusals(argv, match, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match=match):
        PCLI.main(argv)
    assert not dist.is_initialized()


def test_cli_parse_mesh():
    assert PCLI.parse_mesh("sp=4") == {"dp": 1, "sp": 4, "tp": 1, "pp": 1, "interleave": 1}
    assert PCLI.parse_mesh("sp=1,dp=1") == {"dp": 1, "sp": 1, "tp": 1, "pp": 1,
                                             "interleave": 1}


def test_make_mesh_takes_the_jax_axis_order():
    """``make_mesh(dp, tp, sp)`` as the JAX ``make_mesh``: a positional call
    means the same mesh in both packages (``make_mesh(1, 4)`` asks for
    tp = 4, which needs an initialised process group)."""
    import inspect

    from candle_video_tpu.parallel.mesh import make_mesh as jax_make_mesh

    names = list(inspect.signature(make_mesh).parameters)
    assert names[:3] == ["dp", "tp", "sp"]
    assert names[:3] == list(inspect.signature(jax_make_mesh).parameters)[:3]
    with pytest.raises(RuntimeError, match="initialised torch.distributed process group"):
        make_mesh(1, 4)
