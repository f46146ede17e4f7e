"""A cell at a size the CPU runs in seconds: the published configuration
with every width and depth cut, for the harness's CPU tests."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    c = copy.deepcopy(json.loads((HERE / "configs" / f"{name}.json").read_text()))
    c["transformer"].update(num_layers=3, num_attention_heads=2, attention_head_dim=64,
                            cross_attention_dim=128, caption_channels=64, in_channels=16,
                            out_channels=16)
    c["vae"].update(latent_channels=16, decoder_block_out_channels=[32, 64, 128],
                    decoder_layers_per_block=[1, 1, 1, 1])
    c["t5"].update(vocab_size=1000, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_layers=2)
    if c["inference"]["skip_block_list"]:
        c["inference"]["skip_block_list"] = [1]
    return c


def mix(name: str) -> dict:
    m = copy.deepcopy(json.loads((HERE / "traffic" / f"{name}.json").read_text()))
    m.update(height=64, width=64, num_frames=25)
    if m["mode"] == "closed":
        m.update(prompt_tokens=16)
    else:
        m.update(rate_per_min=120.0, drain_cap_s=60)
    return m


def cell(name: str):
    """(cell, tiny config, tiny mix, limits, end-to-end metrics, per-layer
    metrics) of the benchmark's cell ``name``."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    w = {c["name"]: c for c in bench["workloads"]}[name]
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return w, config(w["config"]), mix(w["traffic"]), limits, e2e, layer
