"""``correct`` on the CPU at a tiny size: a sound run passes each cell's
limits, and the control (the reference in float8 in the program's place)
and each fault the cells can have fail them.  The look for a card is
skipped; everything else of a run is driven as on the card.

The numbers: each sampled request's final latents (before the decode)
and its video.  The faults: a denoise step that returns its latents
unchanged; half of a
served batch left out (its rows given the other half's videos); a video
altered where it is produced (one frame zeroed).  No cell runs across chips,
so no exchange can be left out."""

import pytest
import torch

import candle_video_tpu_torch.models.ltx_video.pipeline as PL
import candle_video_tpu_torch.models.ltx_video.scheduler as SCH
import candle_video_tpu_torch.serving as SRV
from portbench import program, run, traffic, weights
from portbench.reference import ltx as REF
from portbench.tests import tiny

SEED = 20261018
CLOSED = ["ltx2b-t2v-97f", "ltx13b-w4-t2v-97f", "ltx2b-t2v-257f"]
ALL = CLOSED + ["ltx2b-serve-poisson"]


def _run(name, **mix_over):
    cell, config, mix, limits, e2e, layer = tiny.cell(name)
    mix.update(mix_over)
    return run.run_cell(cell, config, mix, limits, e2e, layer, SEED, 1.0, False, "cpu",
                        run.Phases())


@pytest.mark.parametrize("name", ALL)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", CLOSED)
def test_control_in_float8_is_not_correct(name, monkeypatch):
    cell, config, mix, *_ = tiny.cell(name)
    raw = weights.make(config, SEED, "cpu")

    def control(pipe, prompt, seed, height, width, num_frames, max_sequence_length,
                stage_times=None, step_callback=None):
        ids, mask = traffic.IdTokenizer().encode_batch([prompt], max_sequence_length)
        shape = dict(seed=seed, height=height, width=width, num_frames=num_frames,
                     prec=REF.Precision("fp8"))
        lat, _ = REF.denoise(raw, config, ids=torch.from_numpy(ids).long(),
                             mask=torch.from_numpy(mask).float(), **shape)
        steps = config["inference"]["num_inference_steps"]
        step_callback(steps - 1, steps, lat)
        return REF.decode(raw, config, lat, **shape)[None]

    monkeypatch.setattr(program, "generate", control)
    res = _run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ALL)
def test_sound_run_checks_latents_and_videos(name):
    limits = tiny.cell(name)[3]
    res = _run(name)
    assert set(res["checks"]) == set(limits["compared"]) >= {"rel_rms", "frame_rel_rms"}
    assert ("latent_rel_rms" in limits["compared"]) == (name in ("ltx2b-t2v-97f",
                                                                 "ltx2b-serve-poisson"))
    assert all(0 < c["value"] < c["limit"] for c in res["checks"].values())


def test_a_sampled_request_past_the_window_is_served_after_it(monkeypatch):
    monkeypatch.setattr(traffic, "sample", lambda seed, n, k: [n + 40])
    res = _run("ltx2b-t2v-97f")
    assert res["correct"], res["checks"]
    assert res["attempted"] < 40


def test_served_check_takes_rows_of_a_batch(capsys):
    # every request due at once, so the server batches
    res = _run("ltx2b-serve-poisson", rate_per_min=6000.0)
    assert res["correct"], res["checks"]
    # the check_requests videos and check_batched more rows of a batch
    assert "checked 5 requests, 5 of them rows of a batch" in capsys.readouterr().err


@pytest.mark.parametrize("name", ALL)
def test_step_that_returns_its_state_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(SCH, "step", lambda sample, *a, **k: sample.float())
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", ALL)
def test_altered_video_is_not_correct(name, monkeypatch):
    post = PL.postprocess_video

    def altered(video):
        out = post(video)
        out[:, :, 0] = 0.0
        return out

    monkeypatch.setattr(PL, "postprocess_video", altered)
    assert not _run(name)["correct"]


def test_half_a_served_batch_left_out_is_not_correct(monkeypatch):
    gen = SRV.generate
    batched = []

    def half(pipe, **kw):
        b = kw["prompt_embeds"].shape[0]
        if b < 2:
            return gen(pipe, **kw)
        batched.append(b)
        keep = {k: (v[:b // 2] if torch.is_tensor(v) and v.shape[:1] == (b,) else v)
                for k, v in kw.items()}
        out = gen(pipe, **keep)
        return torch.cat([out, out[:b - b // 2]])

    monkeypatch.setattr(SRV, "generate", half)
    # every request due at once, so the server batches, and every one checked
    res = _run("ltx2b-serve-poisson", rate_per_min=6000.0, check_requests=1000)
    assert batched and not res["correct"]
