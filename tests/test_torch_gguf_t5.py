"""The random GGUF T5 files of ``chip_smoke.py``'s GGUF phase on the CPU, at
narrow widths: ``write_t5_gguf`` fills each payload's fields directly (no
quantizer), and the port reads them back: the inspection tool's ``list``
counts, the dense weights equal to the keep-quantized payloads
dequantized, each role's weights at the std asked for (T5's initializer,
within 15%).  Then the comparison the card's phase holds to
``GGUF_T5_TOL``, with the plain versions: the keep-quantized encode against
the dense one of the same file, 24 Q8_0 blocks and the 2-block Q5_K_M mix,
at 1/8 and 1/4 of the width (the readings behind the limits: the dense
bf16 encoder sits as far from its own f32 run)."""

import contextlib
import io

import pytest
import torch

import chip_smoke as CS
from candle_video_tpu_torch.models.ltx_video import t5 as T5
from candle_video_tpu_torch.models.ltx_video.configs import T5Config
from candle_video_tpu_torch.ops.kernels import int8_weight_matmul as K3
from candle_video_tpu_torch.utils import inspect_weights as IW

torch.set_num_threads(2)

NARROW = T5Config(d_model=256, d_kv=64, d_ff=512, num_heads=4, num_layers=2, vocab_size=512)
ROLE_OF = {"q": "attn_q", "k": "attn_k", "v": "attn_v", "o": "attn_o", "wi_0": "ffn_gate",
           "wi_1": "ffn_up", "wo": "ffn_down"}


@pytest.mark.parametrize("mix", ["Q8_0", "Q5_K_M"])
def test_written_file_reads_back(tmp_path, mix):
    types = CS.Q8_0 if mix == "Q8_0" else CS.Q5_K_M
    path = str(tmp_path / "t5.gguf")
    info = CS.write_t5_gguf(path, NARROW, types, seed=3, device="cpu")
    want_types = {"F32": 2 * NARROW.num_layers + 2}
    for role in CS.T5_ROLES:
        want_types[types[role]] = want_types.get(types[role], 0) + (
            1 if role == "token_embd" else NARROW.num_layers)
    assert info["tensors"] == 7 * NARROW.num_layers + 2 * NARROW.num_layers + 3
    assert info["types"] == want_types

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        IW.main(["list", path])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith(f"# GGUF: {info['tensors']} tensors")
    listed = [ln.rsplit(None, 1)[-1] for ln in lines[1:] if not ln.startswith("  meta ")]
    assert {t: listed.count(t) for t in set(listed)} == want_types

    dense = T5.t5_from_gguf(path, NARROW, "cpu", torch.float32)
    kept = T5.t5_from_gguf(path, NARROW, "cpu", torch.float32, keep_quantized=True)
    std = CS.t5_role_std(NARROW)
    for name, role in ROLE_OF.items():
        w = getattr(dense.blocks[1], name).weight  # [out, in]
        assert abs(w.std().item() / std[role] - 1) < 0.15, (name, w.std().item(), std[role])
        lin = getattr(kept.blocks[1], name)
        qblock = lin.w_q.shape[0] // lin.s.shape[0]
        assert qblock == {"Q8_0": 32, "Q5_K": 32, "Q6_K": 16}[types[role]]
        deq = lin.w_q.float().reshape(-1, qblock, lin.w_q.shape[1]) * lin.s[:, None]
        if lin.b is not None:
            deq = deq + lin.b[:, None]
        torch.testing.assert_close(deq.reshape(lin.w_q.shape).t(), w, rtol=1e-6, atol=1e-9)
        if types[role] == "Q8_0":  # one rounding either way: bit-equal in bf16
            assert torch.equal(K3.dequantize(lin.w_q, lin.s, qblock), w.t().bfloat16())
    assert abs(dense.embedding.std().item() - 1) < 0.15


@pytest.mark.parametrize("mix,layers,width", [("q8_0", 24, 8), ("q8_0", 24, 4),
                                              ("q5_k_m", 2, 4)])
def test_keep_quantized_drift_is_inside_the_card_limit(tmp_path, mix, layers, width):
    cfg = T5Config(d_model=4096 // width, d_ff=10240 // width, num_heads=64 // width,
                   num_layers=layers)
    path = str(tmp_path / "t5.gguf")
    CS.write_t5_gguf(path, cfg, CS.Q8_0 if mix == "q8_0" else CS.Q5_K_M, seed=31,
                     device="cpu")
    got = CS.gguf_t5_drift(path, cfg, "cpu")
    assert got["rel"] <= CS.GGUF_T5_TOL[mix] / 2, got["rel"]  # 2x room to the card
    assert got["rel"] > 0  # the two routes round apart
