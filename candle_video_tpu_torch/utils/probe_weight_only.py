"""Probe the design choices of the weight-only kernels (K3 and K4, the W8 and
W4 instances of ``csrc/weight_only_matmul_hopper.cu``) on the GPU.

Three readings, each a device time per call by ``torch.profiler`` (median
of three profiles of 20 calls) at the shapes of the T5 encode and the 13B
DiT's cross-attention k/v, on random codes and scales from a seed:

- ``plans``: every plan the host could choose (128- or 256-column tiles,
  clusters of 1 to 8 CTAs along K) beside the one ``plan_w8`` /
  ``plan_w4`` chooses;
- ``pack``: the f32 -> bf16 pair rounding by ``cvt.rn.bf16x2`` (the
  kernel's) against an integer round-to-nearest-even with a byte permute,
  which gives the same bits on finite values, in a copy of the library;
- ``ablation``: copies that leave one part of the work out, at 4096^2 on
  the plan and on one CTA per 256-column tile (split 1, so a step's cost
  shows): without the dequant, without the products, without the
  cluster's sum.  Their outputs are wrong and not checked.

The copies are built under ``output/probe_weight_only/`` (gitignored).
Needs one CUDA device and nvcc:

    python -m candle_video_tpu_torch.utils.probe_weight_only [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

SOURCE = "weight_only_matmul_hopper.cu"
OUT = Path(__file__).resolve().parents[2] / "output" / "probe_weight_only"
# (label, format, M, K, N, bias, scale dtype): the path's shapes
CASES = [("K3 T5 q/k/v/o", "w8", 128, 4096, 4096, False, torch.float32),
         ("K3 T5 wi_0/wi_1", "w8", 128, 4096, 10240, False, torch.float32),
         ("K3 T5 wo", "w8", 128, 10240, 4096, False, torch.float32),
         ("K3 13B W8 DiT attn2 k/v", "w8", 128, 4096, 4096, True, torch.float32),
         ("K3 T5 CFG q/k/v/o", "w8", 256, 4096, 4096, False, torch.float32),
         ("K4 T5 q/k/v/o", "w4", 128, 4096, 4096, False, torch.float32),
         ("K4 T5 wi_0/wi_1", "w4", 128, 4096, 10240, False, torch.float32),
         ("K4 T5 wo", "w4", 128, 10240, 4096, False, torch.float32),
         ("K4 DiT attn2 k/v", "w4", 128, 4096, 4096, True, torch.bfloat16),
         ("K4 T5 CFG q/k/v/o", "w4", 256, 4096, 4096, False, torch.float32)]
PLANS = [(bn, z) for bn in (128, 256) for z in (1, 2, 3, 4, 6, 8)]
PACK_VARIANT = [(
    '  uint32_t r;  // the first source goes to the upper half\n'
    '  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(r) : "f"(hi), "f"(lo));\n'
    '  return r;',
    '  uint32_t a = __float_as_uint(lo), b = __float_as_uint(hi);\n'
    '  a += 0x7FFFu + ((a >> 16) & 1u);\n'
    '  b += 0x7FFFu + ((b >> 16) & 1u);\n'
    '  return __byte_perm(a, b, 0x7632);')]
ABLATIONS = {
    # A taken from the raw bytes
    "no dequant": [
        ("dequant8(af, raw[bb][2 * h], raw[bb][2 * h + 1], pair(sc + gr * BN + n));",
         "af[0] = raw[bb][2 * h]; af[1] = raw[bb][2 * h + 1]; af[2] = af[0]; af[3] = af[1];"),
        ("dequant4(af, ra, rb, pair(sc + half * args.tile_elems + gr * BN + n),\n"
         "                       pair(sc + (2 + half) * args.tile_elems + gr * BN + n));",
         "af[0] = ra; af[1] = rb; af[2] = ra; af[3] = rb;")],
    # the dequantized A only kept alive
    "no wgmma": [
        ("for (int bb = 0; bb < NB; ++bb) wgmma_rs_n128(acc[bb], af[ch][bb], db[ch], 1);",
         "for (int bb = 0; bb < NB; ++bb) acc[bb][0] += __uint_as_float(af[ch][bb][0] ^ "
         "af[ch][bb][1] ^ af[ch][bb][2] ^ af[ch][bb][3]) + (float)(db[ch] & 1);")],
    "no cluster sum": [
        ("for (int base = threadIdx.x - 128; base < items; base += UNROLL * 256) {",
         "for (int base = threadIdx.x - 128; base < 0; base += UNROLL * 256) {")],
}


def _device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def device_ms(fn, iters: int = 20, repeats: int = 3, tries: int = 3):
    """Median over ``repeats`` profiles of the weight-only kernel's device
    ms per call of ``fn``; a profile that dropped records (a count that is
    not ``iters``) is taken again, up to ``tries`` times.  None if the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages() if "weight_only_matmul_kernel" in e.key]
            if rows and sum(e.count for e in rows) == iters:
                break
        if rows:
            runs.append(sum(_device_us(e) for e in rows) / 1e3 / iters)
    return statistics.median(runs) if runs else None


def make_case(case, g):
    """(launch(plan), plan_of(**forced)) of one case on random inputs."""
    from candle_video_tpu_torch.ops.kernels import int4_weight_matmul as K4
    from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3

    _, fmt, m, k, n, with_bias, sdt = case
    dev = torch.device("cuda")
    slots = K3.cluster_slots(dev.index or 0)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    bias = (torch.randn(n, generator=g, device=dev) * 0.1).bfloat16() if with_bias else None
    s = ((torch.rand(k // 32, n, generator=g, device=dev) * 1e-3 + 1e-4)).to(sdt)
    if fmt == "w8":
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        return (lambda p: K3._launch(x, w, s, bias, 32, p),
                lambda **kw: K3.plan_w8(m, k, n, 32, slots, **kw))
    w = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    mn = (-7.5 * s.float()).to(sdt)
    return (lambda p: K4._launch(x, w, s, mn, bias, 32, p),
            lambda **kw: K4.plan_w4(m, k, n, 32, s.element_size(), slots, **kw))


def probe(card: str) -> dict:
    from candle_video_tpu_torch.ops.kernels import _build

    g = torch.Generator(device="cuda").manual_seed(5)
    runs = {case[0]: make_case(case, g) for case in CASES}
    out = dict(card=card, plans={}, pack={}, ablation={})
    for label, (launch, plan_of) in runs.items():
        chosen = plan_of()
        row = {"chosen": f"bn={chosen['bn']} split={chosen['split']}"}
        for bn, z in PLANS:
            try:
                p = plan_of(bn=bn, split=z)
            except ValueError:  # no ring of this width fits, or fewer steps than z
                continue
            row[f"bn={bn} split={z}"] = device_ms(lambda: launch(p))
        out["plans"][label] = row
        print(f"[plans] {label}: chosen {row['chosen']} ({row[row['chosen']]} ms); "
              + " ".join(f"{k}: {v}" for k, v in row.items() if k != "chosen")
              + f" | {card}", flush=True)

    def on_plan():
        return {label: device_ms(lambda: launch(plan_of())) for label, (launch, plan_of)
                in runs.items()}

    cvt = on_plan()
    with _build.patched(OUT / "pack", SOURCE, PACK_VARIANT):
        rne = on_plan()
    for label in runs:
        out["pack"][label] = dict(cvt=cvt[label], integer_rne=rne[label])
        print(f"[pack] {label}: device ms with cvt.rn.bf16x2 {cvt[label]}, with the integer "
              f"round-to-nearest-even {rne[label]} | {card}", flush=True)

    square = {}
    for fmt in ("K3", "K4"):
        launch, plan_of = runs[f"{fmt} T5 q/k/v/o"]
        square[f"{fmt} plan"] = (launch, plan_of())
        square[f"{fmt} split 1"] = (launch, plan_of(bn=256, split=1))

    def timed():
        return {label: device_ms(lambda: launch(p)) for label, (launch, p) in square.items()}

    rows = {"full": timed()}
    for name, subs in ABLATIONS.items():
        with _build.patched(OUT / name.replace(" ", "_"), SOURCE, subs):
            rows[name] = timed()
    for label, (_, p) in square.items():
        out["ablation"][label] = {name: r[label] for name, r in rows.items()}
        print(f"[ablation] {label} 4096^2 (bn={p['bn']} split={p['split']}, "
              f"{p['steps'] // p['split']} steps a CTA): device ms "
              + ", ".join(f"{name} {r[label]}" for name, r in rows.items()) + f" | {card}",
              flush=True)
    return out


def main(argv=None) -> int:
    import subprocess

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_weight_only: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = probe(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
