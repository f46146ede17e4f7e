"""K5 (one ring-attention step) and the ring attention of the PyTorch port
against the JAX package on the CPU.

- K5's plain version (the wrapper's route for CPU tensors) against JAX
  ``ring_chunk_update`` in interpret mode, its m and l read out of the
  lane-packed ``stat`` as ``ops/ring.py`` reads them: one step and a 3-step
  recurrence, D 64 and 128, ragged Sc; f32 at atol = rtol = 1e-4, bf16 at
  rel <= 4e-3 (p rounds to bf16 on both sides, summation orders differ).
- K5's schedule on the card (the ring mode of
  ``csrc/flash_attention_hopper.cu``: the state seeded in log2 units, a
  running max across 128-key tiles, bf16 p) emulated in torch against the
  plain version and the JAX kernel at ``chip_smoke.py``'s K5 limits.
- ``ring_attention`` and ``sequence_parallel_attention`` in gloo rings of 2
  and 4 ranks against the JAX functions on the virtual 8-device mesh at
  1e-4; the port's ring (K5's plain version on the CPU) is held against both
  JAX chunk paths, the Pallas kernel ("pallas") and the plain one ("xla").

Ranks are subprocesses that import this module, which imports only the
port (the tests import JAX inside their bodies); each rank asserts that
neither ``jax`` nor ``candle_video_tpu`` was imported, runs with one torch
thread and meets the others through a ``FileStore``.
"""

import gc
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from candle_video_tpu_torch.ops.kernels import _build
from candle_video_tpu_torch.ops.kernels import ring_chunk as K5
from candle_video_tpu_torch.parallel import Mesh, make_mesh, ring_attention
from candle_video_tpu_torch.parallel import sequence_parallel_attention

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
MODULE = os.path.splitext(os.path.basename(__file__))[0]


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

_MESHES = {}


def mesh_of(dp, sp):
    """One mesh per (dp, sp) and rank process: every rank runs the same jobs
    in the same order, so every rank creates the same groups in turn."""
    if (dp, sp) not in _MESHES:
        _MESHES[dp, sp] = make_mesh(dp=dp, sp=sp)
    return _MESHES[dp, sp]


def _job_ring(q, k, v, scale):
    return ring_attention(*map(torch.from_numpy, (q, k, v)), scale,
                          mesh_of(1, dist.get_world_size())).numpy()


def _job_gather(q, k, v, scale):
    return sequence_parallel_attention(*map(torch.from_numpy, (q, k, v)), scale,
                                       mesh_of(1, dist.get_world_size())).numpy()


JOBS = {"ring": _job_ring, "gather": _job_gather}


def rank_main(rank, world, store, job_file, out_dir, module=MODULE):
    """One rank: join the gloo group, run every job of ``job_file`` (name ->
    (kind, kwargs)) and pickle the results."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    jobs_of = sys.modules[module].JOBS
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        with open(job_file, "rb") as f:
            jobs = pickle.load(f)
        results = {name: jobs_of[kind](**kw) for name, (kind, kw) in jobs.items()}
        leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "candle_video_tpu" or m.startswith("candle_video_tpu.")]
        assert not leaked, leaked
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        # The cached meshes hold the sub-groups: dropped first, their gloo
        # threads end inside destroy_process_group.  Left alive, the groups
        # are destroyed during interpreter shutdown, which now and then
        # aborts the rank ("terminate called without an active exception")
        # after its results were written.
        _MESHES.clear()
        dist.destroy_process_group()
        gc.collect()
        assert _gloo_threads() == [], _gloo_threads()


def _gloo_threads():
    """The names of this process's gloo threads ("gloo_tcp_loop",
    "pt_gloo_runloop") that are still running."""
    names = []
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/comm") as f:
                name = f.read().strip()
        except FileNotFoundError:  # the thread ended after the listing
            continue
        if "gloo" in name:
            names.append(name)
    return names


def run_world(tmp_path, world, jobs, module=MODULE):
    """Run ``jobs`` in ``world`` rank processes; returns each rank's results."""
    job_file = tmp_path / f"jobs{world}.pkl"
    with open(job_file, "wb") as f:
        pickle.dump(jobs, f)
    store = tmp_path / f"store{world}"
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); import {module} as T; "
            f"T.rank_main(*sys.argv[1:], module={module!r})")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore",
               PYTHONFAULTHANDLER="1")  # a rank that dies shows where
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(store),
                               str(job_file), str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append((p.returncode, err))
    for rc, err in errs:
        assert rc == 0, err[-3000:]
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# K5: plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def _unpack_stat(stat, h, d):
    """JAX's lane-packed stat [B, Sq, H·D] -> (m, l) [B, H, Sq], read as
    ``ring.py`` reads l: the first lane of each head's segment."""
    b, sq, _ = stat.shape
    hp, seg = 128 // d, 128 // (2 * (128 // d))
    st = np.asarray(stat).reshape(b, sq, h // hp, 128)
    m = np.stack([st[..., i * seg] for i in range(hp)], -1).reshape(b, sq, h)
    l = np.stack([st[..., (hp + i) * seg] for i in range(hp)], -1).reshape(b, sq, h)
    return m.transpose(0, 2, 1), l.transpose(0, 2, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("steps,b,sq,sc,h,d,bf16", [
    (1, 1, 40, 128, 4, 64, False),   # one step
    (3, 2, 24, 100, 2, 128, False),  # 3-step recurrence, D = 128, ragged Sc
    (3, 1, 40, 100, 4, 64, True),    # bf16 recurrence, ragged Sc
    (1, 2, 33, 37, 2, 128, True),    # bf16, D = 128, Sc = 37 (one ragged key tile)
], ids=["f32_1step", "f32_3step_d128", "bf16_3step", "bf16_1step_d128"])
def test_k5_plain_matches_pallas_interpret(steps, b, sq, sc, h, d, bf16):
    import jax.numpy as jnp

    from candle_video_tpu.ops.pallas import ring_chunk as JK5

    rng = np.random.default_rng(steps * 100 + d)
    hd = h * d
    q = rng.normal(size=(b, sq, hd)).astype(np.float32) * 2
    kvs = [(rng.normal(size=(b, sc, hd)).astype(np.float32),
            rng.normal(size=(b, sc, hd)).astype(np.float32)) for _ in range(steps)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    scale = d ** -0.5

    stat, jacc = JK5.init_ring_state(b, sq, hd)
    m, l, acc = K5.init_ring_state(b, sq, h, d)
    tq = torch.from_numpy(q).to(tdt)
    for i, (k, v) in enumerate(kvs):
        stat, jacc = JK5.ring_chunk_update(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), stat, jacc,
            num_heads=h, scale=scale, interpret=True)
        got = K5.ring_chunk_update(tq, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                                   m, l, acc, num_heads=h, scale=scale)
        assert got[0] is m and got[1] is l and got[2] is acc  # in place
        jm, jl = _unpack_stat(stat, h, d)
        for name, mine, theirs in (("m", m, jm), ("l", l, jl), ("acc", acc, jacc)):
            if bf16:
                assert _rel(mine.numpy(), theirs) <= 4e-3, (i, name)
            else:
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-4,
                                           rtol=1e-4, err_msg=f"step {i} {name}")
    # acc / l is attention over every chunk's keys
    out = (acc.view(b, sq, h, d) / l.transpose(1, 2)[..., None]).reshape(b, sq, hd)
    kf = np.concatenate([k for k, _ in kvs], 1).reshape(b, -1, h, d)
    vf = np.concatenate([v for _, v in kvs], 1).reshape(b, -1, h, d)
    if bf16:  # the oracle sees the rounded inputs
        rnd = lambda x: torch.from_numpy(x).bfloat16().float().numpy()  # noqa: E731
        q, kf, vf = rnd(q), rnd(kf), rnd(vf)
    s = np.einsum("bshd,bkhd->bhsk", q.reshape(b, sq, h, d), kf) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhsk,bkhd->bshd", p / p.sum(-1, keepdims=True), vf).reshape(b, sq, hd)
    if bf16:
        assert _rel(out.numpy(), want) <= 4e-3
    else:
        np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=1e-4)


def test_k5_init_state_matches_jax():
    from candle_video_tpu.ops.pallas import ring_chunk as JK5

    stat, jacc = JK5.init_ring_state(2, 8, 256)
    m, l, acc = K5.init_ring_state(2, 8, 4, 64)
    jm, jl = _unpack_stat(stat, 4, 64)
    assert m.shape == l.shape == (2, 4, 8) and acc.shape == (2, 8, 256)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(l.numpy(), jl)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert K5.NEG_INF == JK5._NEG_INF


def test_k5_cpu_takes_the_plain_version_and_counts_nothing(rng):
    _build.reset_launches()
    q = torch.from_numpy(rng.normal(size=(1, 16, 128)).astype(np.float32))
    m, l, acc = K5.init_ring_state(1, 16, 2, 64)
    K5.ring_chunk_update(q, q, q, m, l, acc, num_heads=2, scale=0.125)
    assert sum(_build.LAUNCHES.values()) == 0
    assert torch.isfinite(acc).all() and (l > 0).all()


@pytest.mark.parametrize("bad,exc,match", [
    ("head_dim", ValueError, "head dim"),
    ("state_shape", ValueError, "state"),
    ("q_dtype", TypeError, "bfloat16"),
    ("state_dtype", TypeError, "float32"),
    ("device", ValueError, "must be on"),
])
def test_k5_cuda_route_checks(bad, exc, match):
    """The CUDA route's checks (run here on CPU tensors, which it refuses)."""
    b, sq, sc, h, d = 1, 16, 24, 2, 64
    q = torch.zeros(b, sq, h * d, dtype=torch.bfloat16)
    k = v = torch.zeros(b, sc, h * d, dtype=torch.bfloat16)
    m, l, acc = K5.init_ring_state(b, sq, h, d)
    heads = h
    if bad == "head_dim":
        heads = 4  # D = 32
    elif bad == "state_shape":
        m = m[:, :, :-1]
    elif bad == "q_dtype":
        q = q.float()
    elif bad == "state_dtype":
        acc = acc.double()
    with pytest.raises(exc, match=match):
        K5._check(q, k, v, m, l, acc, heads)


# ---------------------------------------------------------------------------
# K5 on Hopper: the ring mode of csrc/flash_attention_hopper.cu, its schedule
# emulated in torch against the plain version and the JAX kernel
# ---------------------------------------------------------------------------

# K5 against its plain version on the card (chip_smoke.py): m and l see only
# f32 summation order, acc carries the bf16 p
K5_TOL = dict(m_scaled=1e-5, l_rel=1e-5, acc_rel=4e-3)
LOG2E = 1.4426950408889634


def _emulate_k5(q, k, v, m, l, acc, *, num_heads, scale):
    """K5's schedule in torch, in place: the carried (m, l, acc) seed the
    running state, m in log2 units (m·log2e); 128-key tiles, scores
    s·scale·log2e with keys >= Sc at -1e30, the running max across tiles,
    p rounded to bf16 for P·V, O and l rescaled by exp2(m_old - m_new); the
    state written back unnormalised, m in natural units."""
    from candle_video_tpu_torch.ops.kernels.flash_attention_packed import launch_params

    b, sq, hd = q.shape
    sc_len, d = k.shape[1], hd // num_heads
    block = launch_params(d, "ring")["block_k"]
    qf = q.reshape(b, sq, num_heads, d).float().transpose(1, 2)
    kf = k.reshape(b, sc_len, num_heads, d).float().transpose(1, 2)
    vf = v.reshape(b, sc_len, num_heads, d).float().transpose(1, 2)
    mm = m[..., None] * LOG2E
    ll = l[..., None].clone()
    o = acc.view(b, sq, num_heads, d).transpose(1, 2).clone()
    for k0 in range(0, sc_len, block):
        keys = torch.arange(k0, k0 + block)
        kt = torch.zeros(b, num_heads, block, d)
        vt = torch.zeros(b, num_heads, block, d)
        n = min(block, sc_len - k0)  # TMA zero-fills the tile past Sc
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        sc = torch.where(keys < sc_len, (qf @ kt.transpose(-1, -2)) * (scale * LOG2E),
                         torch.tensor(-1e30))
        m_new = torch.maximum(mm, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(mm - m_new)
        p = torch.exp2(sc - m_new)
        ll = ll * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vt
        mm = m_new
    m.copy_(mm[..., 0] * (1.0 / LOG2E))
    l.copy_(ll[..., 0])
    acc.copy_(o.transpose(1, 2).reshape(b, sq, hd))
    return m, l, acc


def _state_within(got, want, tol=K5_TOL):
    (gm, gl, ga), (wm, wl, wa) = got, want
    assert float(((gm - wm).abs() / wm.abs().clamp_min(1.0)).max()) <= tol["m_scaled"]
    assert float((gl - wl).norm() / wl.norm()) <= tol["l_rel"]
    assert float((ga - wa).norm() / wa.norm()) <= tol["acc_rel"]


def _ring_inputs(seed, steps, b, sq, sc, h, d):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, sq, h * d)) * 2).bfloat16()
    kvs = [tuple(torch.from_numpy(rng.normal(size=(b, sc, h * d))).bfloat16()
                 for _ in range(2)) for _ in range(steps)]
    return q, kvs


@pytest.mark.parametrize("steps,b,sq,sc,h,d", [
    (2, 2, 100, 65, 4, 64),     # Sc = 65: one tile, 63 slots of padding; ragged Sq
    (3, 1, 130, 129, 2, 64),    # Sc = 129: one key past a tile, 3 steps
    (2, 2, 64, 300, 2, 128),    # D = 128, three tiles a step
], ids=["sc65_ragged_q", "sc129_3step", "d128"])
def test_k5_schedule_emulated_matches_plain(steps, b, sq, sc, h, d):
    """The state after every step within chip_smoke.py's K5 limits."""
    q, kvs = _ring_inputs(steps * 10 + d, steps, b, sq, sc, h, d)
    got, want = K5.init_ring_state(b, sq, h, d), K5.init_ring_state(b, sq, h, d)
    args = dict(num_heads=h, scale=d ** -0.5)
    for k, v in kvs:
        _emulate_k5(q, k, v, *got, **args)
        K5.ring_chunk_update_plain(q, k, v, *want, **args)
        _state_within(got, want)


@pytest.mark.parametrize("steps,sq,sc,h,d", [
    (2, 40, 129, 4, 64),
    (3, 24, 100, 2, 128),
], ids=["2step_sc129", "3step_d128"])
def test_k5_schedule_emulated_matches_pallas_interpret(steps, sq, sc, h, d):
    """Against JAX ``ring_chunk_update`` in interpret mode on the same
    bf16-valued inputs in f32, m and l read out of its lane-packed stat."""
    import jax.numpy as jnp

    from candle_video_tpu.ops.pallas import ring_chunk as JK5

    b = 2
    q, kvs = _ring_inputs(steps * 7 + d, steps, b, sq, sc, h, d)
    f32 = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    stat, jacc = JK5.init_ring_state(b, sq, h * d)
    state = K5.init_ring_state(b, sq, h, d)
    for k, v in kvs:
        stat, jacc = JK5.ring_chunk_update(f32(q), f32(k), f32(v), stat, jacc, num_heads=h,
                                           scale=d ** -0.5, interpret=True)
        _emulate_k5(q, k, v, *state, num_heads=h, scale=d ** -0.5)
        jm, jl = _unpack_stat(stat, h, d)
        _state_within(state, tuple(torch.from_numpy(np.array(x)) for x in (jm, jl, jacc)))


# ---------------------------------------------------------------------------
# ring attention: gloo rings of 2 and 4 ranks against the JAX package
# ---------------------------------------------------------------------------

RING_CASES = [(4, 64), (2, 128)]  # (H, D)


def _qkv(h, d, seed=11, b=2, s=64):
    rng = np.random.default_rng(seed + d)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def ring_world(request, tmp_path_factory):
    world = request.param
    jobs = {}
    for h, d in RING_CASES:
        q, k, v = _qkv(h, d)
        jobs[f"ring_{h}x{d}"] = ("ring", dict(q=q, k=k, v=v, scale=0.125))
        jobs[f"gather_{h}x{d}"] = ("gather", dict(q=q, k=k, v=v, scale=0.125))
    return world, run_world(tmp_path_factory.mktemp(f"ring{world}"), world, jobs)


@pytest.mark.parametrize("h,d", RING_CASES, ids=["4x64", "2x128"])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_ring_attention_matches_jax(ring_world, h, d, jax_impl):
    import jax.numpy as jnp

    from candle_video_tpu.ops.attention import attention_xla
    from candle_video_tpu.parallel import make_mesh as jax_make_mesh
    from candle_video_tpu.parallel.sequence import ring_attention as jax_ring

    world, ranks = ring_world
    q, k, v = _qkv(h, d)
    got = [r[f"ring_{h}x{d}"] for r in ranks]
    for other in got[1:]:  # every rank returns the same full output
        np.testing.assert_array_equal(other, got[0])
    want = np.asarray(jax_ring(*map(jnp.asarray, (q, k, v)), 0.125, jax_make_mesh(sp=world),
                               axis_name="sp", chunk_impl=jax_impl))
    np.testing.assert_allclose(got[0], want, atol=1e-4, rtol=1e-4)
    oracle = np.asarray(attention_xla(*map(jnp.asarray, (q, k, v)), 0.125))
    np.testing.assert_allclose(got[0], oracle, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h,d", RING_CASES, ids=["4x64", "2x128"])
def test_sequence_parallel_attention_matches_jax(ring_world, h, d):
    import jax.numpy as jnp

    from candle_video_tpu.parallel import make_mesh as jax_make_mesh
    from candle_video_tpu.parallel.sequence import sequence_parallel_attention as jax_sp

    world, ranks = ring_world
    q, k, v = _qkv(h, d)
    want = np.asarray(jax_sp(*map(jnp.asarray, (q, k, v)), 0.125, jax_make_mesh(sp=world),
                             axis_name="sp", impl="xla"))
    for r in ranks:
        np.testing.assert_allclose(r[f"gather_{h}x{d}"], want, atol=1e-4, rtol=1e-4)


def test_ring_refusals():
    mesh = Mesh(dp=1, sp=4, dp_rank=0, sp_rank=0, sp_group=None, dp_group=None,
                device=torch.device("cpu"))
    q = torch.zeros(1, 63, 2, 64)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q, q, q, 0.3, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        sequence_parallel_attention(q, q, q, 0.3, mesh)
    with pytest.raises(ValueError, match="cannot be combined"):
        make_mesh(tp=2, sp=2)
    with pytest.raises(RuntimeError, match="initialised torch.distributed process group"):
        make_mesh(tp=2)
