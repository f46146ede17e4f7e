"""Pipeline parallelism of the PyTorch port (``--mesh pp=N[,interleave=K]``):
``parallel/pipeline.py``, ``generate(pp_mesh=)`` and the CLI's mesh flags
on the CPU, in f32, in gloo worlds of 2 and 4.

- ``interleave_layer_order`` and ``schedule_ticks`` equal JAX's.
- ``pipeline_transformer_forward`` (8 layers, per-row timesteps, a caption
  mask, an STG skip row): GPipe with M in {1, 2, 4} and interleaved with
  v = 2 and M <= pp at pp = 2 and 4, and PP x TP on a (2, 2) grid; each
  against JAX ``pipeline_transformer_forward`` on the virtual 8-device mesh
  (max-abs 2e-3, the DiT envelope) and against the port unsharded (2e-5);
  every rank returns the same output.
- ``denoise_loop_pp`` with CFG and rescale (num_conds 2, GPipe and
  interleaved), with STG (num_conds 3) and stochastic: against JAX
  ``denoise_loop_pp`` and the port's ``denoise_loop``.
- ``generate(pp_mesh=)`` equals ``generate()``; the CLI's pp run
  (``cli._run`` on a pipeline mesh) equals a run without a mesh.
- The refusals of the JAX package (``parallel/pipeline.py:178-190``,
  ``models/ltx_video/pipeline.py:937-1039``) and of the CLI's ``--mesh``
  and ``--attn-impl``.

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
from candle_video_tpu_torch.parallel import (
    Mesh,
    PipelineMesh,
    denoise_loop_pp,
    interleave_layer_order,
    make_pipeline_mesh,
    pipeline_transformer_forward,
    schedule_ticks,
    shard_transformer_pp,
)
from candle_video_tpu_torch.utils import rng as R
from test_torch_ring import _MESHES, rank_main, run_world  # noqa: F401  (ranks import it)
from test_torch_tp import cli_latents

torch.set_num_threads(2)

MODULE = "test_torch_pp"
TF_CFG = dict(in_channels=8, out_channels=8, num_attention_heads=2, attention_head_dim=32,
              cross_attention_dim=64, num_layers=8, caption_channels=16)
SIGMAS = np.asarray([1.0, 0.7, 0.3, 0.0], np.float32)
# (pp, tp, interleave, microbatches) by world
FORWARDS = {
    2: [(2, 1, 1, 1), (2, 1, 1, 2), (2, 1, 1, 4), (2, 1, 2, 2), (2, 1, 2, 1)],
    4: [(4, 1, 1, 1), (4, 1, 1, 2), (4, 1, 1, 4), (4, 1, 2, 2), (4, 1, 2, 4), (2, 2, 1, 2),
        (2, 2, 2, 2)],
}


def pp_mesh(pp, tp=1):
    """One pipeline mesh per (pp, tp) and rank process, kept where
    ``rank_main`` drops it before the group is destroyed."""
    if ("pp", pp, tp) not in _MESHES:
        _MESHES["pp", pp, tp] = make_pipeline_mesh(pp, tp)
    return _MESHES["pp", pp, tp]


def _tree(seed=0, num_layers=8):
    import jax

    from candle_video_tpu.models.ltx_video import transformer as JTF

    cfg = JTF.LtxTransformerConfig(**dict(TF_CFG, num_layers=num_layers))
    return jax.tree.map(np.asarray, JTF.init_params(jax.random.PRNGKey(seed), cfg,
                                                    dtype=np.float32))


def _rope(f, h, w, inner):
    cfg = PC.LtxTransformerConfig(**TF_CFG)
    coords = PP.build_video_coords(f, h, w, 25.0)
    grid = coords[None] / np.asarray([cfg.rope_base_num_frames, cfg.rope_base_height,
                                      cfg.rope_base_width], np.float32)
    return tuple(t.numpy() for t in rope_cos_sin(torch.from_numpy(grid), inner,
                                                 cfg.rope_theta))


def _setup(seed=1, f=2, h=2, w=3):
    """JAX ``test_pp``'s inputs: 4 rows at their own timesteps, a random
    caption mask, layer 2 skipped on the last row."""
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2, size=(4, 5)).astype(np.float32)
    mask[:, 0] = 1.0
    skip = np.zeros((TF_CFG["num_layers"], 4), np.float32)
    skip[2, 3] = 1.0
    cos, sin = _rope(f, h, w, 64)
    return dict(tree=_tree(), hidden=rng.normal(size=(4, f * h * w, 8)).astype(np.float32),
                enc=rng.normal(size=(4, 5, 16)).astype(np.float32),
                t=np.asarray([993.0, 500.0, 250.0, 31.0], np.float32), mask=mask, skip=skip,
                cos=cos, sin=sin)


def _model(tree, num_layers=8):
    return PCV.transformer_from_jax(tree, PC.LtxTransformerConfig(
        **dict(TF_CFG, num_layers=num_layers)), device="cpu")


def _args(inp):
    return tuple(map(torch.from_numpy, (inp["hidden"], inp["enc"], inp["t"], inp["cos"],
                                        inp["sin"])))


def _port_forward(inp):
    with torch.no_grad():
        return _model(inp["tree"])(*_args(inp), encoder_attention_mask=torch.from_numpy(
            inp["mask"]), skip_layer_mask=torch.from_numpy(inp["skip"])).numpy()


def _job_forward(inp, pp, tp, v, m):
    mesh = pp_mesh(pp, tp)
    model = shard_transformer_pp(_model(inp["tree"]), mesh, interleave=v)
    with torch.no_grad():
        return pipeline_transformer_forward(
            model, *_args(inp), mesh=mesh, num_microbatches=m,
            encoder_attention_mask=torch.from_numpy(inp["mask"]),
            skip_layer_mask=torch.from_numpy(inp["skip"]), interleave=v).numpy()


def _loop_args(inp, b, num_conds):
    """The denoise loop's inputs: b latents, num_conds guidance rows of
    captions (uncond zeros first), a full mask, the STG skip rows."""
    enc = inp["enc"][:b]
    rows = np.concatenate([np.zeros_like(enc)] + [enc] * (num_conds - 1))
    skip = np.zeros((TF_CFG["num_layers"], num_conds * b), np.float32)
    if num_conds == 3:
        skip[2, 2 * b:] = 1.0
    return dict(latents=inp["hidden"][:b], enc=rows, mask=np.ones((num_conds * b, 5), np.float32),
                skip=skip)


def _port_loop(inp, case, mesh=None):
    """The port's loop, single-process or pipelined on ``mesh``."""
    b, guidance, extra = case
    la = _loop_args(inp, b, guidance["num_conds"])
    schedule = PS.Schedule(sigmas=SIGMAS, timesteps=SIGMAS[:-1] * 1000.0,
                           num_inference_steps=3)
    args = (_model(inp["tree"]), *map(torch.from_numpy, (la["latents"], la["enc"], la["mask"])),
            schedule, torch.from_numpy(inp["cos"]), torch.from_numpy(inp["sin"]))
    kw = dict(guidance, skip_layer_mask=torch.from_numpy(la["skip"]) if la["skip"].any()
              else None, stochastic=extra.get("stochastic", False), noise_key=R.prng_key(7))
    with torch.no_grad():
        if mesh is None:
            return PP.denoise_loop(*args, **kw).numpy()
        return denoise_loop_pp(*args, mesh=mesh, num_microbatches=extra.get("m"),
                               interleave=extra.get("v", 1), **kw).numpy()


CFG2 = dict(num_conds=2, guidance_scale=3.0, guidance_rescale=0.7, stg_scale=0.0)
STG3 = dict(num_conds=3, guidance_scale=3.0, guidance_rescale=0.0, stg_scale=1.5)
LOOPS = {  # name: (batch, guidance, pipeline keywords)
    "cfg": (2, CFG2, {}),
    "cfg_interleaved": (2, CFG2, dict(v=2)),
    "stg": (1, STG3, dict(m=3)),
    "cfg_stochastic": (2, CFG2, dict(stochastic=True)),
}


def _job_loop(inp, name):
    return _port_loop(inp, LOOPS[name], pp_mesh(dist.get_world_size()))


def _tiny_pipe(num_layers=4, stg=False):
    cfg = PC.LtxFullConfig(
        inference=PC.LtxInferenceConfig(guidance_scale=2.0, num_inference_steps=2,
                                        stg_scale=1.0 if stg else 0.0,
                                        skip_block_list=(1,) if stg else ()),
        transformer=PC.LtxTransformerConfig(**dict(TF_CFG, num_layers=num_layers)),
        vae=PC.LtxVaeConfig(), scheduler=PC.FlowMatchEulerSchedulerConfig(shift_terminal=0.1))
    model = PTF.init_random(cfg.transformer, "cpu", torch.float32,
                            generator=torch.Generator().manual_seed(3))
    return PP.LtxPipeline(config=cfg, transformer=model)


def _generate_kw():
    rng = np.random.default_rng(7)
    emb = torch.from_numpy((rng.normal(size=(1, 8, 16)) * 0.3).astype(np.float32))
    mask = torch.ones(1, 8)
    return dict(prompt_embeds=emb, prompt_attention_mask=mask,
                negative_prompt_embeds=torch.zeros_like(emb),
                negative_prompt_attention_mask=mask, height=64, width=64, num_frames=9,
                output_type="latent", seed=5)


def _job_generate():
    """generate() without a mesh, then under the pipeline mesh, GPipe and
    interleaved, each on a fresh pipeline (the mesh cuts it in place)."""
    mesh = pp_mesh(dist.get_world_size())
    out = dict(dense=PP.generate(_tiny_pipe(), **_generate_kw()).numpy())
    for v in (1, 2):
        out[v] = PP.generate(_tiny_pipe(), pp_mesh=mesh, pp_interleave=v,
                             **_generate_kw()).numpy()
    return out


def _job_cli(out_dir):
    from pathlib import Path

    rank = dist.get_rank()
    return dict(dense=cli_latents(Path(out_dir) / f"dense{rank}"),
                pp=cli_latents(Path(out_dir) / f"pp{rank}", pp_mesh(dist.get_world_size())))


def _job_mesh(pp, tp):
    try:
        mesh = pp_mesh(pp, tp)
    except ValueError as e:
        return str(e)
    return dict(pp_rank=mesh.pp_rank, tp_rank=mesh.tp_rank,
                pp_ranks=dist.get_process_group_ranks(mesh.pp_group),
                tp_ranks=None if mesh.tp_group is None
                else dist.get_process_group_ranks(mesh.tp_group))


JOBS = {"forward": _job_forward, "loop": _job_loop, "generate": _job_generate,
        "cli": _job_cli, "mesh": _job_mesh}


def _key(case):
    return "forward_pp{}_tp{}_v{}_m{}".format(*case)


@pytest.fixture(scope="module")
def inp():
    return _setup()


@pytest.fixture(scope="module")
def world2(tmp_path_factory, inp):
    tmp = tmp_path_factory.mktemp("pp2")
    jobs = {_key(c): ("forward", dict(inp=inp, pp=c[0], tp=c[1], v=c[2], m=c[3]))
            for c in FORWARDS[2]}
    jobs.update({f"loop_{n}": ("loop", dict(inp=inp, name=n)) for n in LOOPS})
    jobs.update(generate=("generate", {}), cli=("cli", dict(out_dir=str(tmp))),
                mesh_3=("mesh", dict(pp=3, tp=1)))
    return run_world(tmp, 2, jobs, module=MODULE)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, inp):
    jobs = {_key(c): ("forward", dict(inp=inp, pp=c[0], tp=c[1], v=c[2], m=c[3]))
            for c in FORWARDS[4]}
    jobs.update(mesh_2x2=("mesh", dict(pp=2, tp=2)))
    return run_world(tmp_path_factory.mktemp("pp4"), 4, jobs, module=MODULE)


def test_interleave_order_and_schedule_equal_jax():
    from candle_video_tpu.parallel import interleave_layer_order as jax_order
    from candle_video_tpu.parallel import schedule_ticks as jax_ticks

    for pp in (1, 2, 4):
        for v in (1, 2):
            np.testing.assert_array_equal(interleave_layer_order(48, pp, v),
                                          jax_order(48, pp, v))
            for m in (1, 2, 3, 4):
                assert schedule_ticks(pp, m, v) == jax_ticks(pp, m, v)


def _jax_forward(inp, pp, tp, v, m):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from candle_video_tpu.models.ltx_video import transformer as JTF
    from candle_video_tpu.parallel import make_pipeline_mesh as jax_pp_mesh
    from candle_video_tpu.parallel import pipeline_transformer_forward as jax_forward
    from candle_video_tpu.parallel import shard_transformer_params_pp

    params = jax.tree.map(jnp.asarray, inp["tree"])
    if tp > 1:
        mesh = JaxMesh(np.asarray(jax.devices()[:pp * tp]).reshape(pp, tp), ("pp", "tp"))
        params = shard_transformer_params_pp(params, mesh, tp_axis="tp", interleave=v)
    else:
        mesh = jax_pp_mesh(pp)
        params = shard_transformer_params_pp(params, mesh, interleave=v)
    def fn(p):  # under jit, as the JAX package's PP x TP test runs it
        return jax_forward(
            p, JTF.LtxTransformerConfig(**TF_CFG),
            *map(jnp.asarray, (inp["hidden"], inp["enc"], inp["t"], inp["cos"], inp["sin"])),
            mesh=mesh, num_microbatches=m, encoder_attention_mask=jnp.asarray(inp["mask"]),
            skip_layer_mask=jnp.asarray(inp["skip"]), attn_impl="xla", interleave=v)

    return np.asarray(jax.jit(fn)(params))


@pytest.mark.parametrize("world,case", [(w, c) for w in FORWARDS for c in FORWARDS[w]],
                         ids=[_key(c)[8:] for w in FORWARDS for c in FORWARDS[w]])
def test_pipeline_forward_matches_jax_and_the_port_unsharded(world2, world4, inp, world, case):
    got = [r[_key(case)] for r in {2: world2, 4: world4}[world]]
    for other in got[1:]:  # the last stage's output reaches every rank
        np.testing.assert_array_equal(other, got[0])
    np.testing.assert_allclose(got[0], _jax_forward(inp, *case), atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[0], _port_forward(inp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", list(LOOPS))
def test_denoise_loop_pp_matches_jax_and_the_port_loop(world2, inp, name):
    import jax
    import jax.numpy as jnp

    from candle_video_tpu.models.ltx_video import transformer as JTF
    from candle_video_tpu.parallel import denoise_loop_pp as jax_loop_pp
    from candle_video_tpu.parallel import make_pipeline_mesh as jax_pp_mesh
    from candle_video_tpu.parallel import shard_transformer_params_pp

    b, guidance, extra = LOOPS[name]
    got = [r[f"loop_{name}"] for r in world2]
    np.testing.assert_array_equal(got[1], got[0])
    la = _loop_args(inp, b, guidance["num_conds"])
    mesh, v = jax_pp_mesh(2), extra.get("v", 1)
    want = np.asarray(jax_loop_pp(
        shard_transformer_params_pp(jax.tree.map(jnp.asarray, inp["tree"]), mesh, interleave=v),
        JTF.LtxTransformerConfig(**TF_CFG),
        *map(jnp.asarray, (la["latents"], la["enc"], la["mask"], SIGMAS, SIGMAS[:-1] * 1000.0,
                           inp["cos"], inp["sin"])),
        guidance["guidance_scale"], guidance["guidance_rescale"], guidance["stg_scale"],
        jnp.asarray(la["skip"]), jax.random.PRNGKey(7), mesh=mesh,
        num_conds=guidance["num_conds"], stochastic=extra.get("stochastic", False),
        attn_impl="xla", use_skip=bool(la["skip"].any()), num_microbatches=extra.get("m"),
        interleave=v))
    np.testing.assert_allclose(got[0], want, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got[0], _port_loop(inp, LOOPS[name]), atol=2e-5, rtol=2e-5)


def test_generate_pp_equals_generate(world2):
    for r in world2:
        got = r["generate"]
        assert got["dense"].shape == (1, 2 * 2 * 2, 8)
        for v in (1, 2):
            np.testing.assert_allclose(got[v], got["dense"], atol=2e-5, rtol=2e-5,
                                       err_msg=f"interleave={v}")


def test_cli_pp_run_equals_the_run_without_a_mesh(world2):
    lead = world2[0]["cli"]
    assert world2[1]["cli"]["pp"] is None  # only the lead rank writes
    np.testing.assert_allclose(lead["pp"], lead["dense"], atol=2e-5, rtol=2e-5)


def test_make_pipeline_mesh_lays_out_the_pp_tp_grid(world2, world4):
    """Rank r: stage r // tp, tp coordinate r % tp; its stage column and
    its tp row."""
    for r, res in enumerate(world4):
        got = res["mesh_2x2"]
        assert (got["pp_rank"], got["tp_rank"]) == (r // 2, r % 2)
        assert got["pp_ranks"] == [r % 2, 2 + r % 2]
        assert got["tp_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
    assert all("need 3 ranks for pp=3" in res["mesh_3"] for res in world2)


def _cpu_mesh(pp=1, rank=0):
    return PipelineMesh(pp=pp, pp_rank=rank, pp_group=None, device=torch.device("cpu"))


def test_pipeline_forward_refusals_as_jax(inp):
    """JAX's refusals with its messages (``test_pp.py``), before any
    exchange."""
    args = _args(inp)
    with pytest.raises(ValueError, match="num_layers 8 not divisible by pp\\*v=3"):
        pipeline_transformer_forward(_model(inp["tree"]), *args, mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="num_layers 8 not divisible by pp\\*v=3"):
        shard_transformer_pp(_model(inp["tree"]), _cpu_mesh(3))
    model = shard_transformer_pp(_model(inp["tree"]), _cpu_mesh(4), interleave=2)
    with pytest.raises(ValueError, match="batch 4 not divisible by num_microbatches=3"):
        pipeline_transformer_forward(model, *args, mesh=_cpu_mesh(4), num_microbatches=3,
                                     interleave=2)
    with pytest.raises(ValueError, match="interleave=2 needs num_microbatches<=2 \\(got 4\\)"):
        pipeline_transformer_forward(model, *args, mesh=_cpu_mesh(2), num_microbatches=4,
                                     interleave=2)
    cos, sin = (t.repeat(4, 1, 1) for t in args[3:])
    with pytest.raises(ValueError, match="batch-shared rope"):
        pipeline_transformer_forward(model, *args[:3], cos, sin, mesh=_cpu_mesh(4),
                                     num_microbatches=2, interleave=2)
    with pytest.raises(ValueError, match="not cut for this stage"):
        pipeline_transformer_forward(_model(inp["tree"]), *args, mesh=_cpu_mesh(1))
    with pytest.raises(ValueError, match="one pipeline stage's layers"):
        model(*args)  # the stage's four layers are not the model
    with pytest.raises(ValueError, match="already cut for pp=4"):
        shard_transformer_pp(model, _cpu_mesh(2))


def test_generate_pp_refusals_as_jax():
    kw = _generate_kw()
    sp = Mesh(dp=1, sp=1, dp_rank=0, sp_rank=0, sp_group=None, dp_group=None,
              device=torch.device("cpu"))
    with pytest.raises(ValueError, match="at most one of pp_mesh / sp_mesh"):
        PP.generate(_tiny_pipe(), pp_mesh=_cpu_mesh(), sp_mesh=sp, **kw)
    with pytest.raises(ValueError, match="step_callback is not supported in PP mode"):
        PP.generate(_tiny_pipe(), pp_mesh=_cpu_mesh(), step_callback=lambda *a: None, **kw)
    with pytest.raises(ValueError, match="image conditioning is not supported in PP mode"):
        PP.generate(_tiny_pipe(), pp_mesh=_cpu_mesh(),
                    image_latents=torch.zeros(1, 8, 1, 2, 2), **kw)
    meta = PipelineMesh(pp=1, pp_rank=0, pp_group=None, device=torch.device("meta"))
    with pytest.raises(ValueError, match="pp_mesh is on meta"):
        PP.generate(_tiny_pipe(), pp_mesh=meta, **kw)


def test_generate_pp_of_one_stage_equals_generate():
    """A pipeline of one stage makes no exchange and needs no process group;
    its three guidance rows as three microbatches equal ``generate()``."""
    pipe = _tiny_pipe(stg=True)
    dense = PP.generate(pipe, **_generate_kw())
    got = PP.generate(pipe, pp_mesh=_cpu_mesh(), pp_microbatches=3, **_generate_kw())
    assert pipe.transformer.pp == (1, 1, 0, (0, 1, 2, 3))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the CLI's --mesh and --attn-impl
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "tp=2,sp=2"], "cannot be combined"),
    (["--mesh", "sp=2,pp=2"], "at most one of pp and sp"),
    (["--mesh", "tp=2,interleave=2"], "needs pp=N"),
    (["--mesh", "pp=2", "--dit-int8"], "does not compose with --mesh"),
    (["--mesh", "tp=2", "--dit-int4"], "does not compose with --mesh"),
    (["--mesh", "pp=2", "--serve"], "does not compose with --mesh"),
    (["--mesh", "tp=2,dp=2"], "one video"),
    (["--mesh", "pp=2", "--progress"], "--progress"),
    (["--mesh", "pp=2,interleave=x"], "axis=N"),
    (["--mesh", "tp=2", "--device", "cpu"], "torchrun --nproc_per_node=2"),
    (["--mesh", "pp=2,tp=2", "--device", "cpu"], "torchrun --nproc_per_node=4"),
], ids=["tp_sp", "pp_sp", "interleave_without_pp", "pp_int8", "tp_int4", "pp_serve", "tp_dp",
        "pp_progress", "malformed", "tp_no_torchrun", "pp_tp_no_torchrun"])
def test_cli_tp_pp_refusals(argv, match, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match=match):
        PCLI.main(argv)
    assert not dist.is_initialized()


def test_cli_parse_mesh_takes_tp_pp_and_interleave():
    one = dict(dp=1, sp=1, tp=1, pp=1, interleave=1)
    assert PCLI.parse_mesh("tp=4") == dict(one, tp=4)
    assert PCLI.parse_mesh("pp=4,interleave=2") == dict(one, pp=4, interleave=2)
    assert PCLI.parse_mesh("pp=2,tp=2") == dict(one, pp=2, tp=2)
    assert PCLI.mesh_ranks(PCLI.parse_mesh("pp=2,tp=2")) == 4


def test_cli_attn_impl_refuses_xla_on_the_gpu(monkeypatch):
    monkeypatch.setattr(PCLI, "_run", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(SystemExit, match="no tensor falls back to a plain version"):
        PCLI.main(["--attn-impl", "xla"])


@pytest.mark.parametrize("device,choice", [("cuda", "auto"), ("cuda", "pallas"),
                                           ("cpu", "auto"), ("cpu", "pallas"), ("cpu", "xla")])
def test_cli_attn_impl_accepted_choices(device, choice, monkeypatch):
    """``auto`` and ``pallas`` run the kernels on the GPU; on the CPU every
    choice is the plain path: each reaches the run."""
    ran = []
    monkeypatch.setattr(PCLI, "resolve_device", torch.device)
    monkeypatch.setattr(PCLI, "_run", lambda args, *a: ran.append(args.attn_impl) or 0)
    assert PCLI.main(["--attn-impl", choice, "--device", device]) == 0
    assert ran == [choice]
