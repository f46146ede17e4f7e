"""A model family added by new files alone: a toy family module written to
a directory the family loader is pointed at, and a configuration that names
it, run through ``run.run_cell`` on the CPU with no other file of the
harness touched.  A sound run is ``correct``; its control and a step that
returns its latents unchanged are not; an unknown family, and a family
under a mode it does not serve, end the run with exit code 2 before any
weights are made."""

import sys
import textwrap

import pytest

from portbench import run

SEED = 2 ** 31 + 23

TOY = textwrap.dedent('''
    """A toy family: two steps of lat + 0.5 * w @ tanh(lat) over a latent
    video [1, 3, F, H, W] from the request's seed, decoded by a sigmoid."""
    import torch

    from portbench import traffic

    MODES = ("closed",)
    CONTROL = "bf16"
    STEPS = 2
    MADE = []  # the seeds make_weights was called with


    def _weights(seed, device):
        g = torch.Generator(device=device).manual_seed(seed)
        return {"w": 0.3 * torch.randn(3, 3, generator=g, device=device)}


    def make_weights(config, seed, device):
        MADE.append(seed)
        return _weights(seed, device)


    def build(config, raw, device, done):
        done("build")
        return raw["w"].clone()


    def _noise(seed, i, mix, device):
        g = torch.Generator(device=device).manual_seed(traffic.request_seed(seed, i))
        return torch.randn(1, 3, mix["num_frames"], mix["height"], mix["width"], generator=g,
                           device=device)


    def step(w, lat):
        return lat + 0.5 * torch.einsum("ij,bjfhw->bifhw", w, torch.tanh(lat))


    def request(prog, config, mix, seed, i, stage_times, step_callback):
        lat = _noise(seed, i, mix, prog.device)
        for k in range(STEPS):
            lat = step(prog, lat)
            step_callback(k, STEPS, lat)
        return torch.sigmoid(lat) * 255.0


    def reference_weights(config, seed, device, mix):
        return _weights(seed, device)


    def reference_latents(raw, config, mix, seed, r, device, control=None):
        dtype = torch.float32 if control is None else torch.bfloat16
        noise = _noise(seed, r["index"], mix, device)
        w, lat = raw["w"].to(dtype), noise.to(dtype)
        for _ in range(STEPS):
            flat = lat.reshape(3, -1)
            lat = (flat + 0.5 * (w @ torch.tanh(flat))).reshape(noise.shape)
        return lat.float(), noise


    def reference_video(raw, config, mix, seed, r, lat, device, control=None):
        return torch.sigmoid(lat.float())[0] * 255.0
''')

MIX = {"mode": "closed", "height": 8, "width": 8, "num_frames": 3, "check_requests": 2}
LIMITS = {"compared": ["latent_rel_rms", "rel_rms", "frame_rel_rms"],
          "latent_rel_rms": 1e-4, "rel_rms": 0.02, "frame_rel_rms": 0.03}
E2E = [{"name": "videos_per_min", "unit": "videos/min"}, {"name": "setup_s", "unit": "s"}]
CELL = {"name": "toy-closed", "config": "toy", "traffic": "toy-closed1", "chips": 1}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy family's module, found in ``tmp_path`` by the loader."""
    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(run, "FAMILIES", tmp_path)
    monkeypatch.delitem(sys.modules, "portbench.families.toy", raising=False)
    yield run.family({"family": "toy"})
    sys.modules.pop("portbench.families.toy", None)


def _run(config, mix=MIX):
    return run.run_cell(CELL, config, mix, LIMITS, E2E, [], SEED, 0.3, False, "cpu",
                        run.Phases())


def test_a_sound_run_of_a_new_family_is_correct(toy):
    res = _run({"name": "toy", "family": "toy"})
    assert res["correct"], res["checks"]
    assert toy.MADE == [SEED]
    assert all(0 <= c["value"] < c["limit"] for c in res["checks"].values())
    assert set(res["metrics"]) == {"videos_per_min", "setup_s"}


def test_a_step_that_returns_its_latents_is_not_correct(toy, monkeypatch):
    monkeypatch.setattr(toy, "step", lambda w, lat: lat)
    res = _run({"name": "toy", "family": "toy"})
    assert not res["correct"]
    assert res["checks"]["latent_rel_rms"]["value"] > 100 * LIMITS["latent_rel_rms"]


def test_the_new_familys_control_is_not_correct(toy):
    config = {"name": "toy", "family": "toy"}
    ctx = run.measure(CELL, config, MIX, SEED, 0.3, False, "cpu", run.Phases())
    got = run.check(ctx, MIX, control=toy.CONTROL)
    assert got["requests_checked"] == MIX["check_requests"]
    assert any(got[k] > LIMITS[k] for k in LIMITS["compared"])


@pytest.mark.parametrize("config, mix, said", [
    ({"name": "x", "family": "nonesuch"}, MIX, "no family module"),
    ({"name": "x", "family": "../toy"}, MIX, "no family module"),
    ({"name": "toy", "family": "toy"}, dict(MIX, mode="open"), "serves the modes ['closed']"),
], ids=["unknown", "not-a-name", "mode-it-lacks"])
def test_a_cell_the_family_cannot_run_ends_before_any_weights(toy, config, mix, said, capsys):
    with pytest.raises(SystemExit) as e:
        _run(config, mix)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith("portbench: ") and said in err
    assert toy.MADE == []


def test_a_configuration_without_a_family_is_ltx_video():
    fam = run.family({"name": "x"})
    assert fam is run.family({"name": "x", "family": "ltx_video"})
    assert fam.__name__ == "portbench.families.ltx_video"
    assert set(fam.MODES) == {"closed", "open"} and fam.CONTROL == "fp8"
